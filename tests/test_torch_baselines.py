"""The reference's baselines in the port (``blur_separable_seed``,
``gaussian_pyramid``, ``dog_pyramid``, ``sift_dog_response_levelwise``,
``merge_topk``, ``extract_tile``) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances are ``tests/test_kernels.py``'s: blur rtol 1e-5 / atol 1e-6,
scale space atol 1e-5, with thresholded masks identical.  Within the port
the seed's formulations are bitwise its fused ones (torch contracts no
multiply-add), as the reference's tests hold the pair up to XLA's FMA:
the levelwise SIFT response equals `sift_dog_response` exactly.
``merge_topk`` keeps ``lax.top_k``'s order (ties to the smaller index),
exactly; ``extract_tile`` equals the reference's per tile, and the port's
batched map on a batch of one.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.core import bundle as jbundle
from repro.core import detectors as JD
from repro.core import engine as jengine
from repro.core import nms as jnms
from repro.core import pyramid as jpyr
from repro.data.landsat import synthetic_scene
from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import detectors as D
from repro_torch.core import engine, nms
from repro_torch.core import pyramid as pyr

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BLUR_TOL = dict(rtol=1e-5, atol=1e-6)
SCALE_TOL = dict(rtol=0, atol=1e-5)
SIFT_THR = 0.04 / 3
SMALL = dict(tile=32, halo=24, max_keypoints_per_tile=32)


def scenes(h, w, n=2):
    return np.stack([synthetic_scene(h, w, seed=i) for i in range(n)])


@pytest.mark.parametrize("sigma", [0.8, 1.6, 3.2])
@pytest.mark.parametrize("hw", [(61, 200), (96, 96)])
def test_blur_seed_matches_reference(hw, sigma):
    img = scenes(*hw)
    want = np.asarray(jax.jit(
        lambda x: jpyr.blur_separable_seed(x, sigma))(img))
    got = pyr.blur_separable_seed(torch.from_numpy(img), sigma)
    np.testing.assert_allclose(got.numpy(), want, **BLUR_TOL)
    assert torch.equal(got, pyr.blur_separable(torch.from_numpy(img), sigma))
    # use_kernels: the blur wrapper (its plain twin on a CPU tensor)
    kern = pyr.blur_separable_seed(torch.from_numpy(img), sigma,
                                   use_kernels=True)
    np.testing.assert_allclose(kern.numpy(), want, **BLUR_TOL)


@pytest.mark.parametrize("seed_blur", [False, True], ids=["fused", "seed"])
def test_gaussian_and_dog_pyramids_match_reference(seed_blur):
    img = scenes(70, 90)
    jfn = jpyr.blur_separable_seed if seed_blur else None
    fn = pyr.blur_separable_seed if seed_blur else None
    want = jax.jit(lambda x: jpyr.gaussian_pyramid(x, 3, 3, blur_fn=jfn))(img)
    got = pyr.gaussian_pyramid(torch.from_numpy(img), 3, 3, blur_fn=fn)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCALE_TOL)
    for g, w in zip(pyr.dog_pyramid(got), jpyr.dog_pyramid(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCALE_TOL)


@pytest.mark.parametrize("hw", [(120, 176), (80, 80)])
def test_sift_levelwise_matches_reference_and_fused(hw):
    img = scenes(*hw)
    want = jax.jit(lambda x: JD.sift_dog_response_levelwise(
        x, contrast_threshold=SIFT_THR))(img)
    got = D.sift_dog_response_levelwise(torch.from_numpy(img),
                                        contrast_threshold=SIFT_THR)
    fused = D.sift_dog_response(torch.from_numpy(img),
                                contrast_threshold=SIFT_THR)
    assert len(got) == len(want) == len(fused) == 4
    for g, w, f in zip(got, want, fused):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCALE_TOL)
        np.testing.assert_array_equal(g.numpy() > SIFT_THR,
                                      np.asarray(w) > SIFT_THR)
        assert torch.equal(g, f)
    assert int((got[0] > SIFT_THR).sum()) > 0
    kern = D.sift_dog_response_levelwise(torch.from_numpy(img),
                                         contrast_threshold=SIFT_THR,
                                         use_kernels=True)
    for g, k in zip(got, kern):
        assert torch.equal(g, k)


@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_matches_reference(seed, k):
    """Scores drawn from a few values, so ties cross the two sets: the
    order and the payloads are ``lax.top_k``'s exactly."""
    rng = np.random.RandomState(seed)
    sa = rng.randint(0, 4, (3, 16)).astype(np.float32) / 4
    sb = rng.randint(0, 4, (3, 12)).astype(np.float32) / 4
    pa = {"i": np.arange(48, dtype=np.int32).reshape(3, 16),
          "y": rng.rand(3, 16).astype(np.float32)}
    pb = {"i": np.arange(48, 84, dtype=np.int32).reshape(3, 12),
          "y": rng.rand(3, 12).astype(np.float32)}
    top, payload = jnms.merge_topk(jnp.asarray(sa), pa, jnp.asarray(sb), pb, k)
    got_top, got = nms.merge_topk(
        torch.from_numpy(sa), {n: torch.from_numpy(v) for n, v in pa.items()},
        torch.from_numpy(sb), {n: torch.from_numpy(v) for n, v in pb.items()},
        k)
    np.testing.assert_array_equal(got_top.numpy(), np.asarray(top))
    for n in ("i", "y"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(payload[n]))
    _, pair = nms.merge_topk(torch.from_numpy(sa), [torch.from_numpy(pa["i"])],
                             torch.from_numpy(sb), [torch.from_numpy(pb["i"])],
                             k)
    np.testing.assert_array_equal(pair[0].numpy(), np.asarray(payload["i"]))


@pytest.fixture(scope="module")
def small_bundle():
    return jbundle.tile_scene(synthetic_scene(128, 128, seed=3),
                              JaxConfig(**SMALL))


@functools.lru_cache(maxsize=None)
def _jax_tile(alg):
    return jax.jit(functools.partial(jengine.extract_tile, alg,
                                     JaxConfig(**SMALL)))


@pytest.mark.parametrize("alg", PAPER_ALGORITHMS)
def test_extract_tile_matches_reference(small_bundle, alg):
    cfg = DifetConfig(**SMALL)
    tiles = torch.from_numpy(np.asarray(small_bundle.tiles))
    headers = torch.from_numpy(np.asarray(small_bundle.headers))
    batch = engine.extract_tile_multi([alg], cfg, tiles, headers,
                                      use_kernels=False)[alg]
    for i in (0, 5):
        want = {k: np.asarray(v) for k, v in _jax_tile(alg)(
            small_bundle.tiles[i], small_bundle.headers[i]).items()}
        for use_kernels in (False, True):
            got = engine.extract_tile(alg, cfg, tiles[i], headers[i],
                                      use_kernels=use_kernels)
            assert set(got) == set(want)
            for key in ("count", "ys", "xs", "valid"):
                np.testing.assert_array_equal(got[key].numpy(), want[key],
                                              err_msg=key)
            np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                                       rtol=1e-5, atol=1e-7)
            if "desc" in want:
                if want["desc"].dtype == np.uint32:
                    np.testing.assert_array_equal(
                        got["desc"].numpy(), want["desc"].view(np.int32))
                else:
                    np.testing.assert_allclose(got["desc"].numpy(),
                                               want["desc"], rtol=0, atol=1e-5)
        plain = engine.extract_tile(alg, cfg, tiles[i], headers[i],
                                    use_kernels=False)
        for key, v in plain.items():
            assert torch.equal(v, batch[key][i]), key
