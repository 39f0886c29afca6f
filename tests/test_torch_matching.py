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
        is matcher.launch


def segment_rows(nk, n_seg, g):
    """The database rows of segment ``g`` of ``n_seg`` in the order its
    block visits them (csrc/matcher.cu): the WINDOW-row windows g,
    g + n_seg, g + 2 n_seg, ... ."""
    win = torch.arange(g, -(-nk // matcher.WINDOW), n_seg)
    rows = (win[:, None] * matcher.WINDOW
            + torch.arange(matcher.WINDOW)).reshape(-1)
    return rows[rows < nk]


# (nq, nk, slots): the scene pair's 2048^2 and the 1M-row stream with one
# block an SM (L2) and two or three (Hamming) on 132 SMs, an odd shape, a
# database smaller than a window, query tiles that fill the card, an empty
# database, and the 262,144-row L2 stream
PLAN_CASES = [(2048, 2048, 132), (2048, 2048, 264), (300, 1000, 264),
              (300, 1000, 132), (64, 50, 132), (2048, 1 << 20, 264),
              (2048, 1 << 20, 396), (8 * 132 * 128, 300, 264), (5, 0, 132),
              (2048, 1 << 18, 132)]


@pytest.mark.parametrize("nq,nk,slots", PLAN_CASES,
                         ids=[f"{a}x{b}-{c}" for a, b, c in PLAN_CASES])
def test_plan_covers_the_database_in_whole_windows_and_fills_the_card(
        nq, nk, slots):
    """The launch plan's segments, interleaved WINDOW-row windows, cover the
    database once, each in increasing row order; its blocks make at most
    one wave, nearly a full one where the database has rows enough, and a
    single segment (no merge) once the query tiles alone fill the card;
    every block gets MIN_SEGMENT_ROWS // WINDOW windows or more (several
    chunks) where the database has them, the scene pair's 2048^2 and the
    streams among them; valid rows that all come first (a top-K list)
    still reach every segment they can fill."""
    n_seg = matcher.plan(nq, nk, slots)
    assert n_seg >= 1
    segs = [segment_rows(nk, n_seg, g) for g in range(n_seg)]
    rows = torch.cat(segs)
    assert torch.equal(torch.sort(rows).values, torch.arange(nk))
    win = matcher.WINDOW
    for seg in segs:
        assert bool((seg[1:] > seg[:-1]).all())
        starts = seg[seg % win == 0]               # whole windows
        assert len(seg) == sum(min(win, nk - int(r)) for r in starts)
    tiles = -(-nq // matcher.QBLOCK)
    assert tiles * n_seg <= max(slots, tiles)
    if tiles >= slots:
        assert n_seg == 1
    if nk >= matcher.MIN_SEGMENT_ROWS:
        per = matcher.MIN_SEGMENT_ROWS // win
        assert all(-(-len(seg) // win) >= per for seg in segs)
    else:
        assert n_seg == 1
    if nk >= slots // tiles * matcher.MIN_SEGMENT_ROWS:
        assert tiles * (n_seg + 1) > slots
    if nq == 2048 and nk >= 2048:
        assert tiles * n_seg >= 128
        front = 413                                # SURF's valid rows
        reached = sum(bool((seg < front).any()) for seg in segs)
        assert reached == min(n_seg, -(-front // win))


# --- the kernel's schedule as plain code: compaction, threads, segments ------
NTR = 16                            # csrc/matcher.cu: threads along a chunk
CHUNK = {"hamming": 64, "l2": 128}  # csrc/matcher.cu Cfg::BR: rows a chunk


def compact_model(flags):
    """``csrc/matcher.cu::compact`` on one step of 1024 flags: flag
    k * 256 + warp * 32 + lane is thread (warp, lane)'s k-th; a ballot per
    (k, warp), an exclusive scan over the 32 ballots' popcounts in (k, warp)
    order, and a lane's rank among the set bits below it.  -> the rows in
    the ring's order."""
    f = flags.reshape(4, 8, 32)
    counts = f.sum(axis=2).reshape(32)
    offset = (np.cumsum(counts) - counts).reshape(4, 8)
    rank = np.cumsum(f, axis=2) - f
    ring = np.full(int(counts.sum()), -1)
    for k, w, lane in zip(*np.nonzero(f)):
        ring[offset[k, w] + rank[k, w, lane]] = k * 256 + w * 32 + lane
    return ring


def kernel_model(d, v, segments, rng, chunk):
    """(best, second, idx) of a distance matrix ``d`` [Q, K] (masking not
    applied) scheduled as the kernel does: each of ``segments`` (its rows in
    visiting order) has its valid rows compacted in order
    (``compact_model``, 1024 flags a step) and cut into chunks, thread t of
    NTR taking rows t, t + NTR, ... of every chunk in order (first-occurrence
    argmin = the strictly-less push); the threads' triples merged by
    ``merge_best2`` in a random butterfly, the segments' in a random order."""
    big = (matcher.BIG_HAMMING if d.dtype == torch.int32
           else float("inf"))
    nq = d.shape[0]
    segs = []
    for seg in segments:
        seg = np.asarray(seg, np.int64)
        rows = []
        for s0 in range(0, len(seg), 1024):
            f = np.zeros(1024, bool)
            part = seg[s0:s0 + 1024]
            f[:len(part)] = v[part]
            rows += [part[r] for r in compact_model(f)]
        rows = np.asarray(rows, np.int64)
        parts = []
        for t in range(NTR):
            mine = np.concatenate([rows[c + t:c + chunk:NTR]
                                   for c in range(0, len(rows), chunk)]
                                  + [np.zeros(0, np.int64)])
            part = matcher._init(nq, "hamming" if big == matcher.BIG_HAMMING
                                 else "l2", d.device)
            if len(mine):
                b, s, a = matcher._chunk_best2(d[:, mine], 0, big)
                part = (b, s, torch.from_numpy(mine)[a.long()].to(torch.int32))
            parts.append(part)
        rng.shuffle(parts)
        while len(parts) > 1:                     # a butterfly, pair by pair
            parts = [matcher.merge_best2(parts[i], parts[i + 1])
                     if i + 1 < len(parts) else parts[i]
                     for i in range(0, len(parts), 2)]
        segs.append(parts[0])
    order = rng.permutation(len(segs))
    out = segs[order[0]]
    for i in order[1:]:
        out = matcher.merge_best2(out, segs[i])
    return out


def _distances(q, db, metric):
    """The full [Q, K] matrix of distances the twins rank on (L2 without
    |q|^2), masking not applied."""
    if metric == "hamming":
        return matcher.popcount32(q[:, None, :] ^ db[None, :, :]) \
            .sum(dim=-1).to(torch.int32)
    return (db * db).sum(dim=-1)[None, :] - 2.0 * (q @ db.T)


MERGE_CASES = [(m, c, p) for m in ("hamming", "l2")
               for c in ("random", "ties at the cuts", "all equal",
                         "all invalid", "one valid row", "sparse",
                         "valid rows first")
               for p in ("cuts", "windows")]


@pytest.mark.parametrize("metric,case,partition", MERGE_CASES,
                         ids=[f"{m}-{c.replace(' ', '_')}-{p}"
                              for m, c, p in MERGE_CASES])
def test_merge_in_any_order_over_any_partition_is_the_reference(
        metric, case, partition):
    """The kernel's schedule (in-order compaction of each segment's valid
    rows, strided thread subsets, ``merge_best2`` across threads and
    segments in random order), over seeded random contiguous segments or
    the kernel's interleaved windows (``segment_rows``) for a random
    segment count, gives the triple of ``best2_full`` on the same
    distances, and equals ``best2_scan`` and the JAX ``ops.match_best2``
    (Hamming bitwise; L2 on integer-valued descriptors, whose sums are
    exact, bitwise too).  Duplicate rows straddle the segment cuts, the
    window edges and the threads' strides."""
    rng = np.random.RandomState(MERGE_CASES.index((metric, case, partition)))
    nq, nk, width = 37, 2500, 8 if metric == "hamming" else 64
    if metric == "hamming":
        q = rng.randint(0, 2 ** 32, (nq, width), dtype=np.uint64) \
            .astype(np.uint32)
        db = rng.randint(0, 2 ** 32, (nk, width), dtype=np.uint64) \
            .astype(np.uint32)
        db[:, 1:] = q[0, 1:]                      # distances of a few bits
    else:
        q = rng.randint(-3, 4, (nq, width)).astype(np.float32)
        db = rng.randint(-3, 4, (nk, width)).astype(np.float32)
    v = rng.rand(nk) < 0.8
    cuts = np.unique(np.concatenate(
        [[0, nk], rng.choice(np.arange(1, nk), 6, replace=False)]))
    if partition == "cuts":
        segments = [np.arange(a, b) for a, b in zip(cuts[:-1], cuts[1:])]
    else:
        cuts = np.arange(0, nk + 1, matcher.WINDOW)
        n_seg = int(rng.randint(1, nk // matcher.MIN_SEGMENT_ROWS + 1))
        segments = [segment_rows(nk, n_seg, g).numpy()
                    for g in range(n_seg)]
    if case == "ties at the cuts":
        for c in cuts[1:-1]:
            db[c] = db[c - 1]                     # one row each side of a cut
        db[1::NTR] = db[::NTR][:len(db[1::NTR])]  # neighbours in two threads
    elif case == "all equal":
        db[:] = db[5]
    elif case == "all invalid":
        v[:] = False
    elif case == "one valid row":
        v[:] = False
        v[1717] = True
    elif case == "sparse":                       # ~20% valid, scattered
        v = rng.rand(nk) < 0.2
    elif case == "valid rows first":             # a top-K list, as SURF's
        v = np.arange(nk) < 413
    tq, tdb, tv = to_torch(q, db, v)
    vi = tv.to(torch.int32)
    big = matcher.big_for(metric)
    d = _distances(tq, tdb, metric)
    got = kernel_model(torch.where(vi[None, :] != 0, d,
                                   torch.full_like(d, big)), v, segments, rng,
                       CHUNK[metric])
    if metric == "l2":
        got = matcher._l2_qnorm(tq, *got[:2]) + (got[2],)
    for a, b in zip(got, matcher.best2_full(tq, tdb, vi, metric=metric)):
        assert torch.equal(a, b)
    want = jops.match_best2(jnp.asarray(q), jnp.asarray(db), jnp.asarray(v),
                            metric=metric, path="jnp_full")
    for ref_triple in (matcher.best2_scan(tq, tdb, vi, metric=metric),
                       [torch.from_numpy(np.array(w).view(np.int32)
                                         if metric == "hamming"
                                         else np.array(w)) for w in want]):
        for a, b in zip(got, ref_triple):
            assert torch.equal(a, b)
    if case == "all equal":
        assert (got[2] == int(np.argmax(v))).all()
        assert torch.equal(got[0], got[1])
    if case == "all invalid":
        assert (got[0] == big).all() and (got[1] == big).all()
        assert (got[2] == 0).all()
    if case == "one valid row":
        assert (got[2] == 1717).all() and (got[1] == big).all()


def test_merge_rule_equals_in_order_merge_on_random_triples():
    """On any two triples over disjoint rows, the lexicographic merge in
    either order equals the reference's strictly-less merge taken in
    database order, ties and duplicate distances included."""
    rng = np.random.RandomState(5)
    n = 20000
    d = torch.from_numpy(rng.randint(0, 6, (n, 4)).astype(np.int32))
    i = torch.from_numpy(np.sort(rng.choice(1000, (n, 4)), axis=1)
                         .astype(np.int32))
    # rows 0-1 belong to the earlier part, rows 2-3 to the later one
    first = (torch.minimum(d[:, 0], d[:, 1]),
             torch.where(d[:, 0] <= d[:, 1], d[:, 1], d[:, 0]),
             torch.where(d[:, 0] <= d[:, 1], i[:, 0], i[:, 1]))
    later = (torch.minimum(d[:, 2], d[:, 3]),
             torch.where(d[:, 2] <= d[:, 3], d[:, 3], d[:, 2]),
             torch.where(d[:, 2] <= d[:, 3], i[:, 2], i[:, 3]))
    want = matcher._merge_best2(first, later)
    for got in (matcher.merge_best2(first, later),
                matcher.merge_best2(later, first)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.2, 0.8, 1.0])
def test_compaction_keeps_database_order(frac):
    """``compact_model`` (the kernel's ballot, popcount and scan offsets)
    puts the valid rows of a step in increasing order, so the strictly-less
    push still meets each query's rows in database order."""
    flags = np.random.RandomState(int(frac * 100)).rand(1024) < frac
    np.testing.assert_array_equal(compact_model(flags), np.nonzero(flags)[0])


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
    # shapes are checked on every route, the launch's included
    for path in ops.MATCH_PATHS:
        with pytest.raises(ValueError, match="db_valid"):
            ops.match_best2(q, db, torch.ones(7, dtype=torch.int32),
                            metric="l2", path=path)
        with pytest.raises(ValueError, match=r"\[K, D\]"):
            ops.match_best2(q, torch.zeros(8, 5), metric="l2", path=path)
    with pytest.raises(ValueError, match="db_valid"):
        matcher.match(q, db, torch.ones(8), metric="l2")


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
