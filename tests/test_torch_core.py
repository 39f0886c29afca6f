"""``repro_torch.core`` (and its copied data/config modules) against the JAX
package on the same numpy inputs, on the CPU.

Exact where the reference is exact: padding, tiling, integral images,
NMS masks, counts, keypoint indices, packed bits.  Float maps within the
tolerances of ``tests/test_kernels.py`` (rtol 1e-5, atol 1e-6 to 1e-7) with
identical thresholded masks; SIFT/SURF descriptors within atol 1e-5.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.core import bundle as jbundle
from repro.core import descriptors as JDS
from repro.core import detectors as JD
from repro.core import nms as jnms
from repro.core import pyramid as jpyr
from repro.data import landsat as jlandsat
from repro_torch import convert
from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import bundle, nms
from repro_torch.core import descriptors as DS
from repro_torch.core import detectors as D
from repro_torch.core import pyramid as pyr
from repro_torch.core.padding import reflect_pad
from repro_torch.data import landsat

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def scenes(h, w, n=2):
    return np.stack([jlandsat.synthetic_scene(h, w, seed=i) for i in range(n)])


def close(got, want, rtol=1e-5, atol=1e-7, thr=None):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if thr is not None:
        np.testing.assert_array_equal(got > thr, want > thr)


# --- copied numpy modules ---------------------------------------------------
def test_config_and_algorithms_match_reference():
    assert dataclasses.asdict(DifetConfig()) == dataclasses.asdict(JaxConfig())
    from repro.configs.difet_paper import PAPER_ALGORITHMS as JALGS
    assert PAPER_ALGORITHMS == JALGS
    assert convert.config_from_reference(
        dataclasses.asdict(JaxConfig(tile=64))) == DifetConfig(tile=64)
    with pytest.raises(ValueError):
        convert.config_from_reference({"tile": 64})


def test_brief_pattern_carries_across():
    ref_pairs = JDS.brief_pairs(256, 31)
    np.testing.assert_array_equal(DS.brief_pairs(256, 31), ref_pairs)
    t = convert.brief_pairs_from_reference(ref_pairs)
    assert t.dtype == torch.int32 and t.shape == (256, 4)
    with pytest.raises(ValueError):
        convert.brief_pairs_from_reference(ref_pairs[::-1])


@pytest.mark.parametrize("hw,seed", [((64, 80), 0), ((37, 129), 5)])
def test_synthetic_scenes_match_reference(hw, seed):
    np.testing.assert_array_equal(landsat.synthetic_scene(*hw, seed=seed),
                                  jlandsat.synthetic_scene(*hw, seed=seed))
    np.testing.assert_array_equal(
        landsat.synthetic_scene_rgba(*hw, seed=seed),
        jlandsat.synthetic_scene_rgba(*hw, seed=seed))


def test_tiling_matches_reference(tmp_path):
    gray = jlandsat.synthetic_scene(100, 77, seed=2)
    rgba = jlandsat.synthetic_scene_rgba(50, 61, seed=3)
    cfg, jcfg = DifetConfig(tile=32, halo=8), JaxConfig(tile=32, halo=8)
    for s in (gray, rgba):
        np.testing.assert_array_equal(bundle.rgba_to_gray(s),
                                      jbundle.rgba_to_gray(s))
    got = bundle.bundle_scenes([gray, rgba], cfg).pad_to(40)
    want = jbundle.bundle_scenes([gray, rgba], jcfg).pad_to(40)
    np.testing.assert_array_equal(got.tiles, want.tiles)
    np.testing.assert_array_equal(got.headers, want.headers)
    store = bundle.BundleStore(tmp_path)
    store.put("b", got)
    back = store.get("b")
    assert back.cfg == cfg and store.list() == ["b"]
    np.testing.assert_array_equal(back.tiles, got.tiles)
    store.put_result("b", {"count": np.arange(3)})
    assert store.has_result("b")
    np.testing.assert_array_equal(store.get_result("b")["count"], np.arange(3))


# --- padding and pyramid ----------------------------------------------------
@pytest.mark.parametrize("n,pad", [(10, 3), (10, 9), (10, 34), (2, 5), (1, 4)])
def test_reflect_pad_is_multi_bounce(n, pad):
    x = np.arange(2 * n * (n + 1), dtype=np.float32).reshape(2, n, n + 1)
    want = np.asarray(jnp.pad(x, ((0, 0), (pad, pad), (pad, pad)),
                              mode="reflect"))
    np.testing.assert_array_equal(reflect_pad(torch.from_numpy(x), pad).numpy(),
                                  want)


def test_scale_constants_match_reference():
    for s in (0.8, 1.0, 1.6, 2.0, 3.2):
        np.testing.assert_array_equal(pyr.gaussian_kernel_1d(s),
                                      jpyr.gaussian_kernel_1d(s))
    for spo, s0 in [(3, 1.6), (2, 1.6), (3, 1.2)]:
        assert pyr.octave_increments(spo, s0) == jpyr.octave_increments(spo, s0)


@pytest.mark.parametrize("sigma", [1.0, 1.6, 2.0])
def test_blur_and_sobel_match_reference(sigma):
    img = scenes(61, 90)
    x = torch.from_numpy(img)
    close(pyr.blur_separable(x, sigma), jpyr.blur_separable(img, sigma),
          atol=1e-6)
    gx, gy = pyr.sobel_gradients(x)
    jgx, jgy = jpyr.sobel_gradients(img)
    close(gx, jgx, atol=1e-7)
    close(gy, jgy, atol=1e-7)


@pytest.mark.parametrize("hw", [(80, 80), (22, 22), (137, 70)])
def test_integral_image_is_bitwise_reference(hw):
    img = scenes(*hw)
    got = pyr.integral_image(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpyr.integral_image(img)))
    ii = pyr.integral_image(torch.from_numpy(img))
    np.testing.assert_array_equal(
        pyr.box_sum(ii, -2, -4, 5, 3).numpy(),
        np.asarray(jpyr.box_sum(jpyr.integral_image(img), -2, -4, 5, 3)))


@pytest.mark.parametrize("hw,use_kernels", [((96, 128), True),
                                            ((96, 128), False),
                                            ((416, 560), True)])
def test_fused_octave_response_matches_both_reference_routes(hw, use_kernels):
    """At 96x128 the reference fuses the octave (pad once) when kernels are
    on; at 416x560 it takes the per-level path even then (its octave-fusion
    rule), and the port must follow it to compute the same maps."""
    img = scenes(*hw, n=1)
    base = np.asarray(jpyr.blur_separable(img, 1.6))
    thr = 0.04 / 3
    got = pyr.fused_octave_response(torch.from_numpy(base), 3, thr,
                                    use_kernels=use_kernels)
    want = jpyr.fused_octave_response(base, 3, thr, use_pallas=use_kernels)
    close(got[0], want[0], rtol=0, atol=1e-5, thr=thr)
    close(got[1], want[1], rtol=0, atol=1e-5)


# --- NMS and selection ------------------------------------------------------
def test_nms_plateaus_match_reference():
    rng = np.random.RandomState(0)
    resp = (rng.randint(0, 4, (3, 23, 31)) / 4.0).astype(np.float32)
    resp[0, 5:9, 5:9] = 1.0                        # a plateau
    got = nms.nms3x3(torch.from_numpy(resp)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnms.nms3x3(resp)))
    assert (got[0, 4:10, 4:10] == 1.0).sum() == 1  # one keypoint per plateau


def test_topk_breaks_ties_toward_smaller_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    mask = torch.ones(1, 1, 5, dtype=torch.bool)
    ys, xs, scores, valid = nms.topk_keypoints(x.reshape(1, 1, 5), 2, 0.0,
                                               mask)
    assert xs.tolist() == [[1, 2]] and scores.tolist() == [[3.0, 3.0]]
    assert valid.all()


def test_selection_matches_reference():
    rng = np.random.RandomState(1)
    resp = (rng.randint(0, 6, (4, 40, 36)) / 6.0).astype(np.float32)
    vh, vw = np.array([16, 10, 16, 3]), np.array([12, 12, 5, 12])
    got_mask = nms.interior_mask((40, 36), 8, torch.from_numpy(vh),
                                 torch.from_numpy(vw))
    for i in range(4):
        want_mask = np.asarray(jnms.interior_mask((40, 36), 8, vh[i], vw[i]))
        np.testing.assert_array_equal(got_mask[i].numpy(), want_mask)
        c = nms.count_above(torch.from_numpy(resp[i:i + 1]), 0.3,
                            got_mask[i:i + 1])
        assert int(c) == int(jnms.count_above(resp[i], 0.3, want_mask))
        got = nms.topk_keypoints(torch.from_numpy(resp[i:i + 1]), 20, 0.3,
                                 got_mask[i:i + 1])
        want = jnms.topk_keypoints(resp[i], 20, 0.3, want_mask)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(wnt))


# --- detectors (the plain path, use_kernels=False) -------------------------
@pytest.mark.parametrize("name", ["harris", "shi_tomasi", "fast", "surf"])
def test_detector_maps_match_reference(name):
    img = scenes(64, 96)
    x = torch.from_numpy(img)
    if name == "harris":
        close(D.harris_response(x), JD.harris_response(img), thr=1e-6)
    elif name == "shi_tomasi":
        close(D.shi_tomasi_response(x), JD.shi_tomasi_response(img), thr=1e-4)
    elif name == "fast":
        close(D.fast_score(x), jax.jit(JD.fast_score)(img), atol=1e-6,
              thr=0.0)
    else:
        close(D.surf_hessian_response(x), JD.surf_hessian_response(img),
              atol=1e-7, thr=400.0 / 255.0 ** 2)


def test_sift_octaves_match_reference():
    img = scenes(120, 176)
    thr = 0.04 / 3
    got = D.sift_dog_response(torch.from_numpy(img), contrast_threshold=thr)
    want = jax.jit(functools.partial(JD.sift_dog_response,
                                     contrast_threshold=thr))(img)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        close(g, w, rtol=0, atol=1e-6, thr=thr)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_engine_sift_map_is_one_octave_call(monkeypatch, use_kernels):
    """The engine's SIFT response computes octave 0 alone (one call of
    ``fused_octave_response``), and its map still equals the reference
    engine's ``sift_dog_response(..., n_octaves=4)[0]``."""
    from repro.core import engine as jengine
    from repro_torch.core import engine
    real, calls = D.fused_octave_response, []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(D, "fused_octave_response", counting)
    img = scenes(120, 176)
    cfg = DifetConfig()
    got = engine._sift_resp(torch.from_numpy(img), cfg, use_kernels)
    assert calls == [(2, 120, 176)]
    got2 = engine._sift_resp(torch.from_numpy(img), cfg, use_kernels)
    assert len(calls) == 2 and torch.equal(got, got2)
    want = jax.jit(functools.partial(jengine._sift_resp, cfg=JaxConfig(),
                                     use_pallas=use_kernels))(img)
    thr = cfg.sift_contrast_threshold / cfg.scales_per_octave
    close(got, want, rtol=0, atol=1e-6, thr=thr)


@pytest.mark.parametrize("hw,launches", [((96, 128), 1), ((416, 560), 0)])
def test_engine_sift_fuses_octave_zero_only_where_the_reference_does(
        monkeypatch, hw, launches):
    """At a tile whose octave 0 fuses, the kernel route runs the fused
    scale-space octave exactly once per SIFT response; where it does not
    (the paper's 560^2 tiles take the per-level path), never."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    real, calls = ops.scalespace_octave, []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "scalespace_octave", counting)
    assert ops.reference_fuses_octave(*hw, 3) == bool(launches)
    engine._sift_resp(torch.from_numpy(scenes(*hw, n=1)), DifetConfig(), True)
    assert len(calls) == launches


# --- descriptors ------------------------------------------------------------
def _keypoints(n, k, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, h, (n, k)).astype(np.int32),
            rng.randint(0, w, (n, k)).astype(np.int32))


def test_extract_patches_and_pack_bits_are_exact():
    img = scenes(50, 60)
    ys, xs = _keypoints(2, 9, 50, 60)
    got = DS.extract_patches(torch.from_numpy(img), torch.from_numpy(ys),
                             torch.from_numpy(xs), 22)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(JDS.extract_patches(img[i], ys[i],
                                                           xs[i], 22)))
    bits = np.random.RandomState(3).rand(5, 256) > 0.5
    np.testing.assert_array_equal(
        DS.pack_bits(torch.from_numpy(bits)).numpy(),
        np.asarray(JDS.pack_bits(bits)).view(np.int32))


def test_atan2f_is_the_references_arctan2():
    """ORB's angle is fdlibm's ``atan2f`` op for op (`DS.atan2f`), which the
    reference's ``jnp.arctan2`` calls on this CPU: bitwise on random and
    edge inputs, where ``torch.atan2`` is an ulp away on some."""
    rng = np.random.RandomState(2)
    n = 200_000
    y = (rng.randn(n) * 10.0 ** rng.randint(-12, 6, n)).astype(np.float32)
    x = (rng.randn(n) * 10.0 ** rng.randint(-12, 6, n)).astype(np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 0.4375, 0.6875, 1.1875, 2.4375,
                      2.0 ** 25, 2.0 ** -29, 3.0e7], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(-np.inf))])
    ey, ex = np.meshgrid(edges, np.array([1.0, -1.0, 0.0, -0.0, 3.0,
                                          -7.5e-9], np.float32))
    y = np.concatenate([y, ey.ravel()])
    x = np.concatenate([x, ex.ravel()])
    want = np.asarray(jax.jit(jnp.arctan2)(y, x))
    got = DS.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = torch.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert (plain != want).any()


def test_orb_bin_angles_round_once():
    """ORB's cos and sin at its 31 bin angles equal the reference's (XLA's
    are correctly rounded there); torch's float32 ones are an ulp off at
    some, which moves a rotated pair's rounding."""
    tq = torch.arange(-15, 16, dtype=torch.float32) * (2 * np.pi / 30.0)
    want = [np.asarray(jax.jit(f)(tq.numpy())) for f in (jnp.cos, jnp.sin)]
    for fn, w in zip((torch.cos, torch.sin), want):
        np.testing.assert_array_equal(DS._rn(fn, tq).numpy(), w)
    assert any((fn(tq).numpy() != w).any()
               for fn, w in zip((torch.cos, torch.sin), want))


@pytest.mark.parametrize("name", ["sift", "surf", "brief", "orb"])
def test_descriptors_match_reference(name):
    img = scenes(80, 80)
    ys, xs = _keypoints(2, 24, 80, 80, seed=4)
    fn = {"sift": DS.sift_descriptors, "surf": DS.surf_descriptors,
          "brief": DS.brief_descriptors, "orb": DS.orb_descriptors}[name]
    jfn = {"sift": JDS.sift_descriptors, "surf": JDS.surf_descriptors,
           "brief": JDS.brief_descriptors, "orb": JDS.orb_descriptors}[name]
    got = fn(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    for i in range(2):
        want = np.asarray(jax.jit(jfn)(img[i], ys[i], xs[i]))
        if want.dtype == np.uint32:
            np.testing.assert_array_equal(got[i].numpy(), want.view(np.int32))
        else:
            np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                       atol=1e-5)
