"""The port's matching path (``repro_torch.kernels.{matcher,ops,index}``,
``repro_torch.core.matching``) against the JAX package's, on the
CPU, on the same numpy inputs.

Hamming results are exact (the reference's uint32 words viewed as int32).
L2 distances within rtol 1e-5 / atol 1e-4, the tolerance of
``tests/test_matcher.py``, with equal indices.  RANSAC gets the reference's
own uniform draws (``jax.random.uniform`` as numpy), so inlier sets are
exact and offsets, rms, scale and angle within 1e-4.  On CPU tensors the
CUDA paths run their plain twins; the kernels themselves are held against
the twins on the card by ``chip_smoke.py``.
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
from repro.core import engine as jengine
from repro.core import matching as jmatching
from repro.data.landsat import synthetic_scene
from repro.kernels import index as jindex
from repro.kernels import matcher as jmatcher
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import matching
from repro_torch.core import mosaic
from repro_torch.kernels import index, matcher, ops, ref

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHAPES = [(37, 53), (64, 128), (130, 300), (257, 511)]
STRADDLE = {"hamming": (64, 3 * 512 + 129), "l2": (37, 2 * 2048 + 1)}
JAX_PATHS = ("jnp_full", "jnp_stream", "pallas_resident", "pallas_stream")


def packed(n, seed, words=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 32, size=(n, words),
                       dtype=np.uint64).astype(np.uint32)


def floats(n, seed, d=128):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def mask(n, seed, frac=0.8):
    return np.random.RandomState(seed).rand(n) < frac


def inputs(metric, nq, nk, d):
    if metric == "hamming":
        q, db = packed(nq, 0), packed(nk, 1)
    else:
        q, db = floats(nq, 0, d), floats(nk, 1, d)
    return q, db, mask(nk, 2)


def to_torch(q, db, v):
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a)
    return t(q), t(db), torch.from_numpy(v)


def assert_triple(got, want, metric, err=""):
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    if metric == "hamming":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.view(np.int32), err_msg=err)
    else:
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4,
                                       err_msg=err)
        np.testing.assert_array_equal(got[2], want[2], err_msg=err)


CASES = ([("hamming", 8, s) for s in SHAPES + [STRADDLE["hamming"]]]
         + [("l2", 128, s) for s in SHAPES + [STRADDLE["l2"]]]
         + [("l2", 64, s) for s in (SHAPES[0], SHAPES[2])])


@pytest.mark.parametrize("metric,d,shape", CASES,
                         ids=[f"{m}{d}-{s[0]}x{s[1]}" for m, d, s in CASES])
def test_every_path_matches_every_reference_path(metric, d, shape):
    """The twins and ``ops.match_best2`` on each port path against the
    reference's ``ops.match_best2`` on its four paths (Pallas in interpret
    mode), which agree with each other."""
    q, db, v = inputs(metric, *shape, d)
    want = {p: jops.match_best2(jnp.asarray(q), jnp.asarray(db),
                                jnp.asarray(v), metric=metric, path=p,
                                interpret=True) for p in JAX_PATHS}
    tq, tdb, tv = to_torch(q, db, v)
    vi = tv.to(torch.int32)
    got = {"best2_full": matcher.best2_full(tq, tdb, vi, metric=metric),
           "best2_scan": matcher.best2_scan(tq, tdb, vi, metric=metric),
           "best2_stream": matcher.best2_stream(tq, tdb, vi, metric=metric)}
    for p in ops.MATCH_PATHS:
        got[p] = ops.match_best2(tq, tdb, tv, metric=metric, path=p)
    for gname, g in got.items():
        for wname, w in want.items():
            assert_triple(g, w, metric, err=f"{gname} vs {wname}")


@pytest.mark.parametrize("metric", ["hamming", "l2"])
def test_oracles_match_reference_and_blocked_equals_plain(metric):
    q, db, v = inputs(metric, 23, 1000, 64)
    want = jref.match_best2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v),
                            metric=metric)
    tq, tdb, tv = to_torch(q, db, v)
    plain = ref.match_best2(tq, tdb, tv, metric=metric)
    assert_triple(plain, want, metric)
    blocked = ref.match_best2_blocked(tq, tdb, tv, metric=metric, block=300)
    for a, b in zip(blocked, plain):
        assert torch.equal(a, b)
    jblocked = jref.match_best2_blocked(jnp.asarray(q), jnp.asarray(db),
                                        jnp.asarray(v), metric=metric,
                                        block=300)
    assert_triple(blocked, jblocked, metric)


def test_popcount_of_words_with_the_top_bit_set():
    words = np.array([0xFFFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF,
                      0x7FFFFFFF, 0, 1, 0xF0F0F0F0], np.uint32)
    want = np.asarray(jmatcher.popcount32(jnp.asarray(words)))
    got = matcher.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [bin(int(w)).count("1")
                                        for w in words])
    # distances between words with the top bit set stay exact
    q, db = packed(9, 4) | 0x80000000, packed(31, 5) | 0x80000000
    v = np.ones(31, bool)
    want = jref.match_best2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v),
                            metric="hamming")
    tq, tdb, tv = to_torch(q, db, v)
    for p in ops.MATCH_PATHS:
        assert_triple(ops.match_best2(tq, tdb, tv, metric="hamming", path=p),
                      want, "hamming", err=p)


@pytest.mark.parametrize("metric", ["hamming", "l2"])
def test_all_invalid_database(metric):
    q, db, _ = inputs(metric, 10, 20, 64)
    v = np.zeros(20, bool)
    tq, tdb, tv = to_torch(q, db, v)
    big = matcher.big_for(metric)
    want = jops.match_best2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v),
                            metric=metric, path="jnp_full")
    for p in ops.MATCH_PATHS:
        best, second, idx = ops.match_best2(tq, tdb, tv, metric=metric, path=p)
        assert (best == big).all() and (second == big).all(), p
        assert (idx == 0).all(), p
        assert_triple((best, second, idx), want, metric, err=p)
    m = matching.match_pair(tq, torch.ones(10, dtype=torch.bool), tdb, tv,
                            use_kernels=False)
    assert not bool(m.ok.any())


def test_candidate_paths_by_backend():
    """On the card auto dispatch always takes the kernel; the plain route
    runs only when asked for, or on the CPU, sized by FULL_MAX_ROWS.  No
    path is measured, so nothing depends on the shape beyond K."""
    p = ops.match_path
    big = ops.FULL_MAX_ROWS + 1
    for use in (None, True):
        assert p(100, use_kernels=use, backend="cuda") == "cuda_stream"
        assert p(big, use_kernels=use, backend="cuda") == "cuda_stream"
    for backend in ("cuda", "cpu"):
        assert p(100, use_kernels=False, backend=backend) == "torch_full"
        assert p(ops.FULL_MAX_ROWS, use_kernels=False,
                 backend=backend) == "torch_full"
        assert p(big, use_kernels=False, backend=backend) == "torch_stream"
    assert p(100, backend="cpu") == "torch_full"
    assert p(big, backend="cpu") == "torch_stream"
    assert p(100, use_kernels=True, backend="cpu") == "cuda_stream"
    assert set(ops.MATCH_PATHS) == {"torch_full", "torch_stream",
                                    "cuda_resident", "cuda_stream"}
    # both of the reference's kernels map onto the one launch
    assert ops._PATH_FNS["cuda_resident"] is ops._PATH_FNS["cuda_stream"] \
        is matcher.match


@pytest.mark.parametrize("nq,nk", [(2048, 2048), (300, 1000), (64, 50),
                                   (2048, 1 << 20), (8 * 132 * 128, 300),
                                   (5, 0)])
def test_segments_cover_the_database_and_fill_the_card(nq, nk):
    """The launch's segments are whole kernel chunks that cover the
    database once; the grid reaches BLOCKS_PER_SM blocks per SM wherever
    the database has rows enough, and is one segment (no merge) once the
    query tiles alone fill the card."""
    n_sm = 132
    rows, n_seg = matcher.segments(nq, nk, n_sm)
    assert rows % matcher.SEGMENT_ALIGN == 0 and n_seg >= 1
    assert rows * n_seg >= nk and rows * (n_seg - 1) < max(nk, 1)
    tiles = -(-nq // matcher.QBLOCK)
    want = matcher.BLOCKS_PER_SM * n_sm
    if tiles >= want:
        assert n_seg == 1
    elif nk >= want * matcher.SEGMENT_ALIGN:
        assert tiles * n_seg >= want
    if nk <= matcher.SEGMENT_ALIGN:
        assert n_seg == 1


def test_match_best2_rejects_bad_input():
    q, db = torch.zeros(4, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError, match="unknown path"):
        ops.match_best2(q, db, metric="l2", path="bogus")
    with pytest.raises(ValueError, match="unknown metric"):
        ops.match_best2(q, db, metric="cosine")
    with pytest.raises(TypeError, match="bit-packed"):
        ops.match_best2(q, db, metric="hamming")
    with pytest.raises(TypeError, match="float"):
        ops.match_best2(q.long(), db.long(), metric="l2")
    with pytest.raises(TypeError):
        matching.infer_metric(torch.zeros(3, 8, dtype=torch.uint8))
    assert matching.infer_metric(torch.zeros(3, 8, dtype=torch.int32)) \
        == "hamming"
    assert matching.infer_metric(torch.zeros(3, 8)) == "l2"
    with pytest.raises(ValueError, match="contiguous"):
        matcher.match(q.T.contiguous().T, db,
                               torch.ones(8, dtype=torch.int32), metric="l2")


# --- RANSAC with the reference's draws -----------------------------------------
def _translation_case():
    rng = np.random.RandomState(7)
    k = 400
    pa = rng.rand(k, 2).astype(np.float32) * 500
    pb = pa + np.array([-42.0, 117.0], np.float32)
    out = rng.rand(k) < 0.4
    pb[out] += rng.randn(out.sum(), 2) * 90 + 15
    return pa, pb.astype(np.float32), rng.rand(k) < 0.85


def _similarity_case():
    rng = np.random.RandomState(11)
    k = 400
    pa = rng.rand(k, 2).astype(np.float32) * 300
    z = 1.25 * np.exp(1j * 0.4)
    cb = z * (pa[:, 1] + 1j * pa[:, 0]) + (30.0 - 14.0j)
    pb = np.stack([cb.imag, cb.real], -1).astype(np.float32)
    out = rng.rand(k) < 0.3
    pb[out] += rng.randn(out.sum(), 2) * 60
    return pa, pb.astype(np.float32), ~out


def _draws(shape, seed=0):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("none_valid", [False, True])
def test_estimate_translation_with_reference_draws(none_valid):
    pa, pb, ok = _translation_case()
    if none_valid:
        ok = np.zeros_like(ok)
    key = jax.random.PRNGKey(3)
    want = jmatching.estimate_translation(pa, pb, ok, key)
    got = matching.estimate_translation(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(ok),
        torch.from_numpy(np.array(jax.random.uniform(key, (128,)))))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    _close(got.t, want.t)
    _close(got.rms, want.rms)
    if not none_valid:
        np.testing.assert_allclose(got.t.numpy(), [-42.0, 117.0], atol=1e-3)


def test_estimate_similarity_with_reference_draws():
    """complex64 on both sides; scale, angle, offset and rms within 1e-4."""
    pa, pb, ok = _similarity_case()
    want = jmatching.estimate_similarity(pa, pb, ok)
    got = matching.estimate_similarity(
        torch.from_numpy(pa), torch.from_numpy(pb), torch.from_numpy(ok),
        torch.from_numpy(_draws((256, 2))))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    for name in ("scale", "theta", "t", "rms"):
        _close(getattr(got, name), getattr(want, name))
    assert abs(float(got.scale) - 1.25) < 1e-3
    assert abs(float(got.theta) - 0.4) < 1e-3


def test_uniform_draws_are_deterministic_per_pair():
    a = matching.uniform_draws((128,), seed=0, index=3)
    assert torch.equal(a, matching.uniform_draws((128,), seed=0, index=3))
    assert not torch.equal(a, matching.uniform_draws((128,), seed=0, index=4))
    assert a.dtype == torch.float32 and bool(((a >= 0) & (a < 1)).all())


# --- matching extracted descriptors of two overlapping crops --------------------
SMALL = dict(tile=64, halo=24, max_keypoints_per_tile=128,
             fast_threshold=0.08, sift_contrast_threshold=0.01)


@functools.lru_cache(maxsize=None)
def _crop_features(alg):
    """The reference's extraction of two crops 100 columns apart."""
    base = synthetic_scene(160, 300, seed=9, density=4.0)
    out = []
    for crop in (base[:, :200], base[:, 100:]):
        b = jbundle.tile_scene(np.ascontiguousarray(crop), JaxConfig(**SMALL))
        r = jax.jit(lambda t, h: jengine.extract_features(
            t, h, alg, JaxConfig(**SMALL)))(b.tiles, b.headers)
        out.append({k: np.asarray(v) for k, v in r.items()})
    return out


def _port_feats(f):
    d = f["top_desc"]
    t = lambda a: torch.from_numpy(np.array(a))
    return {"desc": t(d.view(np.int32) if d.dtype == np.uint32 else d),
            "valid": t(f["top_valid"]), "ys": t(f["top_ys"]),
            "xs": t(f["top_xs"])}


@pytest.mark.parametrize("alg", ["brief", "sift"])
def test_match_pair_exact_on_extracted_descriptors(alg):
    fa, fb = _crop_features(alg)
    want = jmatching.match_pair(fa["top_desc"], fa["top_valid"],
                                fb["top_desc"], fb["top_valid"])
    pa, pb = _port_feats(fa), _port_feats(fb)
    ok_w = np.asarray(want.ok)
    assert ok_w.sum() >= 8, "too few matches in the test scene"
    for use in (None, True, False):
        got = matching.match_pair(pa["desc"], pa["valid"], pb["desc"],
                                  pb["valid"], use_kernels=use)
        np.testing.assert_array_equal(got.ok.numpy(), ok_w)
        np.testing.assert_array_equal(got.idx_b.numpy()[ok_w],
                                      np.asarray(want.idx_b)[ok_w])
    # registration with the reference's RANSAC draws (its default key)
    _, jest = jmatching.register_pair(
        fa["top_ys"], fa["top_xs"], fa["top_desc"], fa["top_valid"],
        fb["top_ys"], fb["top_xs"], fb["top_desc"], fb["top_valid"])
    _, est = matching.register_pair(
        pa["ys"], pa["xs"], pa["desc"], pa["valid"], pb["ys"], pb["xs"],
        pb["desc"], pb["valid"], torch.from_numpy(_draws((128,))))
    assert int(est.n_inliers) == int(jest.n_inliers) >= 8
    np.testing.assert_array_equal(est.inliers.numpy(),
                                  np.asarray(jest.inliers))
    _close(est.t, jest.t)
    np.testing.assert_allclose(est.t.numpy(), [0.0, -100.0], atol=1e-3)


@pytest.mark.parametrize("alg", ["brief", "sift"])
def test_match_pair_approx_on_extracted_descriptors(alg):
    """Approx mode through indexes carried over from the reference's state:
    the same candidates, so the same matches."""
    fa, fb = _crop_features(alg)
    want_idx = [jindex.build_index(f["top_desc"], f["top_valid"])
                for f in (fa, fb)]
    want = jax.jit(lambda da, va, db, vb: jmatching.match_pair(
        da, va, db, vb, mode="approx", index_a=want_idx[0],
        index_b=want_idx[1]))(fa["top_desc"], fa["top_valid"],
                              fb["top_desc"], fb["top_valid"])
    pa, pb = _port_feats(fa), _port_feats(fb)
    got_idx = [_carry_index(w, p["desc"], p["valid"])
               for w, p in zip(want_idx, (pa, pb))]
    got = matching.match_pair(pa["desc"], pa["valid"], pb["desc"],
                              pb["valid"], mode="approx",
                              index_a=got_idx[0], index_b=got_idx[1])
    ok_w = np.asarray(want.ok)
    assert ok_w.sum() >= 8
    np.testing.assert_array_equal(got.ok.numpy(), ok_w)
    np.testing.assert_array_equal(got.idx_b.numpy()[ok_w],
                                  np.asarray(want.idx_b)[ok_w])


def _carry_index(jidx, db, valid):
    if isinstance(jidx, jindex.LshIndex):
        return convert.lsh_from_reference(db, valid, jidx._word, jidx._shift,
                                          np.asarray(jidx._lists),
                                          probes=jidx.probes)
    return convert.kmeans_from_reference(db, valid, np.asarray(jidx._cent),
                                         np.asarray(jidx._lists),
                                         probes=jidx.probes)


def test_lsh_index_matches_reference():
    db, v = packed(400, 1), mask(400, 2)
    q = db[:40].copy()
    q[:, 0] ^= 1                                  # near duplicates
    jidx = jindex.LshIndex(db, v, n_tables=4)
    tq, tdb, tv = to_torch(q, db, v)
    carried = _carry_index(jidx, tdb, tv)
    own = index.LshIndex(tdb, tv, n_tables=4)
    np.testing.assert_array_equal(own._word, jidx._word)
    np.testing.assert_array_equal(own._shift, jidx._shift)
    np.testing.assert_array_equal(own._lists.numpy(), np.asarray(jidx._lists))
    assert own.overflow == jidx.overflow
    want_c = np.asarray(jax.jit(jidx.candidates)(q))
    want = jax.jit(jidx.search)(q)
    for idx in (carried, own):
        np.testing.assert_array_equal(idx.candidates(tq).numpy(), want_c)
        assert_triple(idx.search(tq), want, "hamming")
    assert_triple(own.search(tq, probes=3),
                  jax.jit(lambda x: jidx.search(x, 3))(q), "hamming")


def test_kmeans_index_matches_reference():
    db, v = floats(300, 1, 64), mask(300, 2)
    q = db[:30] + 0.01 * floats(30, 3, 64)
    jidx = jindex.KMeansIndex(db, v)
    tq, tdb, tv = to_torch(q, db, v)
    carried = _carry_index(jidx, tdb, tv)
    own = index.KMeansIndex(tdb, tv)
    np.testing.assert_allclose(own._cent.numpy(), np.asarray(jidx._cent),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(own._lists.numpy(), np.asarray(jidx._lists))
    want_c = np.asarray(jax.jit(jidx.candidates)(q))
    want = jax.jit(jidx.search)(q)
    for idx in (carried, own):
        np.testing.assert_array_equal(idx.candidates(tq).numpy(), want_c)
        assert_triple(idx.search(tq), want, "l2")
    assert isinstance(index.build_index(tdb, tv), index.KMeansIndex)
    with pytest.raises(ValueError):
        convert.kmeans_from_reference(tdb, tv, np.zeros((4, 64)),
                                      np.zeros((5, 8), np.int32))


def test_rerank_masks_duplicates_and_breaks_ties_low():
    db = torch.from_numpy(packed(10, 6).view(np.int32))
    db[7] = db[3]                                 # a tie at distance 0
    q = db[3:4].clone()
    cand = torch.tensor([[7, 3, 3, -1, 7, 5]], dtype=torch.int32)
    valid = torch.ones(10, dtype=torch.bool)
    best, second, idx = index.rerank_exact(q, db, valid, cand,
                                           metric="hamming")
    assert int(best) == 0 and int(second) == 0 and int(idx) == 3
    jb, js, ji = jindex.rerank_exact(jnp.asarray(q.numpy().view(np.uint32)),
                                     jnp.asarray(db.numpy().view(np.uint32)),
                                     jnp.asarray(valid.numpy()),
                                     jnp.asarray(cand.numpy()),
                                     metric="hamming")
    assert [int(np.asarray(a)[0]) for a in (jb, js, ji)] == [0, 0, 3]


def test_pair_solver_batch_equals_single_calls():
    """The reference's vmap over pairs becomes a loop: each pair's result in
    a batch equals its single-pair registration."""
    rng = np.random.RandomState(0)
    p, k = 3, 64
    ys = rng.randint(0, 200, (p, k)).astype(np.int32)
    xs = rng.randint(0, 200, (p, k)).astype(np.int32)
    desc = packed(p * k, 8).view(np.int32).reshape(p, k, 8)
    valid = np.ones((p, k), bool)
    draws = np.stack([matching.uniform_draws((32,), 0, i).numpy()
                      for i in range(p)])
    solve = mosaic.make_pair_solver(None, 0.8, 2.0, 32, device="cpu")
    out = solve(ys, xs, desc, valid, ys + 5, xs - 9, desc, valid, draws)
    assert out["t"].shape == (p, 2) and out["n_inliers"].shape == (p,)
    for i in range(p):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a[i]))
        m, est = matching.register_pair(
            t(ys), t(xs), t(desc), t(valid), t(ys + 5), t(xs - 9), t(desc),
            t(valid), t(draws), iters=32)
        assert torch.equal(out["t"][i], est.t)
        assert int(out["n_inliers"][i]) == int(est.n_inliers) == k
        assert int(out["n_matches"][i]) == int(m.ok.sum())
    np.testing.assert_allclose(out["t"].numpy(), np.tile([[5.0, -9.0]],
                                                         (p, 1)), atol=1e-4)
