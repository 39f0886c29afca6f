"""The CUDA kernels' plain twins (``repro_torch.kernels``, run on the CPU)
against the JAX package's Pallas kernels (``repro.kernels.ops``, interpret
mode on the CPU), on the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py``: Harris rtol 1e-5 /
atol 1e-7; blur and FAST rtol 1e-5 / atol 1e-6; scale-space atol 1e-5.
Thresholded masks must be identical.  The kernels themselves build and run
only on a CUDA card; ``chip_smoke.py`` holds them against these twins there.
"""
import os

import numpy as np
import pytest
import torch

from repro.data.landsat import synthetic_scene
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import check_image

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHAPES = [(32, 128), (61, 200)]
# odd/even H/W and an unaligned width, as tests/test_kernels.py SS_SHAPES
SS_SHAPES = [(96, 128), (81, 200), (128, 257)]


def scenes(h, w, n=2):
    return np.stack([synthetic_scene(h, w, seed=i) for i in range(n)])


def close(got, want, rtol, atol, thr=None):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if thr is not None:
        np.testing.assert_array_equal(got > thr, want > thr)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("sigma", [1.0, 2.0])
def test_harris_twin_matches_pallas(hw, sigma):
    img = scenes(*hw)
    got = ops.harris(torch.from_numpy(img), k=0.04, sigma=sigma)
    want = jops.harris(img, k=0.04, sigma=sigma)
    close(got, want, 1e-5, 1e-7, thr=1e-6)


@pytest.mark.parametrize("hw", SHAPES)
def test_shi_tomasi_twin_matches_pallas(hw):
    img = scenes(*hw)
    got = ops.harris(torch.from_numpy(img), shi_tomasi=True)
    want = jops.harris(img, shi_tomasi=True)
    close(got, want, 1e-5, 1e-7, thr=1e-4)


@pytest.mark.parametrize("hw", SHAPES + [(22, 22)])
@pytest.mark.parametrize("sigma", [1.0, 3.2])
def test_blur_twin_matches_pallas(hw, sigma):
    img = scenes(*hw)
    got = ops.gaussian_blur(torch.from_numpy(img), sigma)
    close(got, jops.gaussian_blur(img, sigma), 1e-5, 1e-6)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("threshold", [0.05, 0.15])
def test_fast_twin_matches_pallas(hw, threshold):
    img = scenes(*hw)
    got = ops.fast_score(torch.from_numpy(img), threshold=threshold)
    want = jops.fast_score(img, threshold=threshold)
    close(got, want, 1e-5, 1e-6, thr=0.0)


@pytest.mark.parametrize("hw", SS_SHAPES + [(10, 10)])
def test_scalespace_twin_matches_pallas(hw):
    """Includes a 10x10 octave: the one-time pad of 34 is wider than the
    image, so the reflection bounces (``jnp.pad`` semantics)."""
    base = ref.gaussian_blur(torch.from_numpy(scenes(*hw)), 1.6).numpy()
    thr = 0.04 / 3
    got = ops.scalespace_octave(torch.from_numpy(base),
                                scales_per_octave=3, contrast_threshold=thr)
    want = jops.scalespace_octave(base, scales_per_octave=3,
                                  contrast_threshold=thr)
    close(got[0], want[0], 0.0, 1e-5, thr=thr)
    close(got[1], want[1], 0.0, 1e-5)


@pytest.mark.parametrize("spo,sigma0", [(2, 1.6), (3, 1.2)])
def test_scalespace_twin_other_octaves(spo, sigma0):
    base = ref.gaussian_blur(torch.from_numpy(scenes(81, 200)), sigma0).numpy()
    thr = 0.04 / spo
    got = ops.scalespace_octave(torch.from_numpy(base),
                                scales_per_octave=spo, contrast_threshold=thr,
                                sigma0=sigma0)
    want = jops.scalespace_octave(base, scales_per_octave=spo,
                                  contrast_threshold=thr, sigma0=sigma0)
    close(got[0], want[0], 0.0, 1e-5, thr=thr)
    close(got[1], want[1], 0.0, 1e-5)


def test_scalespace_pad_matches_reference():
    for spo, sigma0 in [(3, 1.6), (2, 1.6), (3, 1.2)]:
        assert ops.scalespace_pad(spo, sigma0) == jops.scalespace_pad(
            spo, sigma0)
    assert ops.scalespace_pad(3, 1.6) == 34


@pytest.mark.parametrize("h,w", [(560, 560), (416, 560), (320, 320),
                                 (304, 304), (280, 280), (176, 176),
                                 (140, 140), (70, 70), (10, 10)])
def test_octave_fusion_rule_matches_reference(h, w):
    """The port fuses exactly the octaves the reference fuses."""
    assert ops.reference_fuses_octave(h, w, 3) == jops.scalespace_fits_vmem(
        h, w, 3)


def test_octave_fusion_rule_at_the_paper_tile():
    # tile 512 + 2 * 24 halo: octave 0 per level, octaves 1-3 fused
    assert not ops.reference_fuses_octave(560, 560, 3)
    assert all(ops.reference_fuses_octave(s, s, 3) for s in (280, 140, 70))


def test_wrappers_keep_rank_and_count_no_cpu_launch():
    ops.reset_launch_counts()
    img = torch.from_numpy(scenes(40, 70)[0])
    assert ops.harris(img).shape == img.shape
    assert ops.fast_score(img).shape == img.shape
    assert ops.gaussian_blur(img[None, None], 1.0).shape == (1, 1, 40, 70)
    resp, seed = ops.scalespace_octave(img, scales_per_octave=3,
                                       contrast_threshold=0.0133)
    assert resp.shape == img.shape and seed.shape == img.shape
    assert ops.launch_counts() == {"harris": 0, "fast": 0, "blur": 0,
                                   "scalespace": 0}


def test_wrapper_input_checks():
    x = torch.zeros(2, 8, 8)
    with pytest.raises(TypeError):
        check_image(x.double(), "t")
    with pytest.raises(ValueError):
        check_image(x[0], "t")
    with pytest.raises(ValueError):
        check_image(x.transpose(1, 2), "t")
    with pytest.raises(ValueError):
        ops.fast_score(x, arc=17)


def test_twin_blur_is_the_pad_once_convention():
    """The blur twin is one reflect pad plus valid passes: it equals the
    production per-level blur, which pads by the same radius."""
    from repro_torch.core.pyramid import blur_separable
    x = torch.from_numpy(scenes(61, 200))
    assert torch.equal(ref.gaussian_blur(x, 1.6), blur_separable(x, 1.6))
