"""The CUDA kernels' plain twins (``repro_torch.kernels``, run on the CPU)
against the JAX package's Pallas kernels (``repro.kernels.ops``, interpret
mode on the CPU), on the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py``: Harris rtol 1e-5 /
atol 1e-7; blur and FAST rtol 1e-5 / atol 1e-6; scale-space atol 1e-5.
Thresholded masks must be identical.  The kernels themselves build and run
only on a CUDA card; ``chip_smoke.py`` holds them against these twins there.
"""
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data.landsat import synthetic_scene
from repro.kernels import ops as jops
from repro_torch.core.pyramid import gaussian_kernel_1d, octave_increments
from repro_torch.kernels import fastscore, ops, ref
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


# 1.0 (SURF's patches), 3.2, and every sigma the main path blurs with:
# SIFT's base 1.6, BRIEF's and ORB's 2.0, octave 0's five increments
MAIN_PATH_SIGMAS = [1.6, 2.0] + list(octave_increments(3, 1.6))


@pytest.mark.parametrize("hw", SHAPES + [(22, 22)])
@pytest.mark.parametrize("sigma", [1.0, 3.2] + MAIN_PATH_SIGMAS)
def test_blur_twin_matches_pallas(hw, sigma):
    img = scenes(*hw)
    got = ops.gaussian_blur(torch.from_numpy(img), sigma)
    close(got, jops.gaussian_blur(img, sigma), 1e-5, 1e-6)


@pytest.mark.parametrize("hw", SHAPES + [(3, 3)])
@pytest.mark.parametrize("threshold", [0.05, 0.15])
@pytest.mark.parametrize("arc", [5, 9, 12])
def test_fast_twin_matches_pallas(hw, threshold, arc):
    """rtol 1e-5 / atol 1e-6 (tests/test_kernels.py's FAST tolerance) and
    equal corner masks; 3^2 is smaller than the pad of 3, so the
    reflection bounces."""
    img = scenes(*hw)
    got = ops.fast_score(torch.from_numpy(img), threshold=threshold, arc=arc)
    want = jops.fast_score(img, threshold=threshold, arc=arc)
    close(got, want, 1e-5, 1e-6, thr=0.0)


def _circular_run(masks, bits, length):
    """True where the circular ``bits``-bit masks hold a run of >= length
    set bits (everywhere for length 0)."""
    d = masks | (masks << bits)
    run = d.copy()
    for j in range(1, length):
        run &= d >> j
    return (run & ((1 << bits) - 1)) != 0 if length else np.ones_like(
        masks, bool)


@pytest.mark.parametrize("arc", range(1, 17))
def test_fast_compass_early_out_never_zeroes_a_corner(arc):
    """Every one of the 65,536 ring flag masks with a circular run of
    >= arc flags has >= compass_run(arc) consecutive compass flags (ring
    indices 0, 4, 8, 12), so the kernel's pre-test keeps every corner.  And
    the rule is the tightest: below arc 16, some corner's compass flags
    hold no run of compass_run(arc) + 1."""
    m = fastscore.compass_run(arc)
    masks = np.arange(1 << 16, dtype=np.uint64)
    compass = sum(((masks >> (4 * j)) & 1) << j for j in range(4))
    corner = _circular_run(masks, 16, arc)
    assert corner.any()
    assert _circular_run(compass, 4, m)[corner].all()
    if arc < 16:
        assert not _circular_run(compass, 4, m + 1)[corner].all()


def test_fast_kernel_ring_is_fast_offsets():
    """csrc/fastscore.cu packs the ring's (dy + 3, dx + 3) one hex digit a
    ring index; they must be FAST_OFFSETS in ring order."""
    from repro_torch.core.detectors import FAST_OFFSETS
    src = (Path(fastscore.__file__).parent / "csrc" / "fastscore.cu") \
        .read_text()
    packed = [int(re.search(rf"{name} = 0x([0-9a-f]{{16}})ull", src)
                  .group(1), 16) for name in ("kRingDY", "kRingDX")]
    ring = [tuple(((p >> (4 * k)) & 15) - 3 for p in packed)
            for k in range(16)]
    assert ring == [tuple(o) for o in FAST_OFFSETS]


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


@pytest.mark.parametrize("spo,sigma0", [(2, 1.6), (3, 1.2), (6, 3.6)])
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


# the widest octaves the kernel takes at 7 and 8 levels (radii up to 16;
# their rings let one block on an SM), and octaves beyond it: 9 levels, or
# a radius above 16 (17 at spo 5, sigma0 4.12 and at spo 6, sigma0 4.66)
WITHIN = [(5, 4.1), (6, 4.65)]
BEYOND = [(7, 1.6), (3, 3.2), (5, 4.12), (6, 4.66), (1, 0.8)]


@pytest.mark.parametrize("spo,sigma0", WITHIN)
def test_scalespace_within_the_kernel_runs(spo, sigma0):
    x = torch.from_numpy(scenes(12, 20, n=1))
    kw = dict(scales_per_octave=spo, contrast_threshold=0.04 / spo,
              sigma0=sigma0)
    got, want = ops.scalespace_octave(x, **kw), ref.scalespace_octave(x, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("spo,sigma0", BEYOND)
def test_scalespace_beyond_the_kernel_raises(spo, sigma0):
    with pytest.raises(ValueError):
        ops.scalespace_octave(torch.zeros(1, 16, 16), scales_per_octave=spo,
                              contrast_threshold=0.01, sigma0=sigma0)


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
    words = torch.zeros(5, 8, dtype=torch.int32)
    for path in ("cuda_resident", "cuda_stream"):
        assert ops.match_best2(words, words, metric="hamming",
                               path=path)[0].shape == (5,)
    assert ops.launch_counts() == {"harris": 0, "fast": 0, "blur": 0,
                                   "scalespace": 0, "matcher": 0,
                                   "select": 0}


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


def test_main_path_sigmas_are_what_the_engine_blurs_with():
    radii = [(len(gaussian_kernel_1d(s)) - 1) // 2 for s in MAIN_PATH_SIGMAS]
    assert radii == [5, 6, 4, 5, 6, 8, 10]


def test_divide_by_8_is_multiply_by_one_eighth_bitwise():
    """The Harris kernel's Sobel divides by 8 as a multiply by 0.125 while
    its twin divides: both round the same real number x / 8, so they agree
    on every float32.  Random bit patterns (subnormals included) and the
    edge values, NaN aside (its bits carry no value)."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2 ** 32, 2_000_000, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0x00000000, 0x80000000, 0x00000001, 0x80000001,
                     0x00000007, 0x00000008, 0x0000000c, 0x007fffff,
                     0x00800000, 0x00800001, 0x7f7fffff, 0xff7fffff,
                     0x7f800000, 0xff800000], np.uint32)
    sub = rng.randint(0, 0x00800000, 100_000).astype(np.uint32)
    bits = np.concatenate([bits, edge, sub, sub | 0x80000000])
    x = bits.view(np.float32)
    x = x[~np.isnan(x)]
    with np.errstate(under="ignore"):
        div = (x / np.float32(8)).view(np.uint32)
        mul = (x * np.float32(0.125)).view(np.uint32)
    np.testing.assert_array_equal(div, mul)
    assert np.isinf(x).sum() >= 2 and (np.abs(x) < 1.18e-38).sum() > 200_000


@pytest.mark.parametrize("kernel", ["blur", "harris", "shi_tomasi"])
def test_offset_view_matches_pallas(kernel):
    """A view one float into a buffer: contiguous, but its rows are 4 bytes
    off 16-byte alignment (on the card it takes the scalar staging)."""
    img = scenes(64, 64)
    view = torch.zeros(1 + img.size)[1:].view(img.shape)
    view.copy_(torch.from_numpy(img))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    check_image(view, kernel)
    if kernel == "blur":
        close(ops.gaussian_blur(view, 1.6), jops.gaussian_blur(img, 1.6),
              1e-5, 1e-6)
    else:
        shi = kernel == "shi_tomasi"
        close(ops.harris(view, k=0.04, shi_tomasi=shi),
              jops.harris(img, k=0.04, shi_tomasi=shi), 1e-5, 1e-7,
              thr=1e-4 if shi else 1e-6)
