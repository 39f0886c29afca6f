"""The keypoint selection's wrapper (``ops.select_keypoints``) on the CPU,
where it runs its plain twin (``core/nms.py::select_keypoints``), against
the JAX reference's selection (``repro/core/nms.py``: ownership, the dense
count, 3x3 NMS and the top-K) tile by tile, dtype for dtype, on numpy maps
built to hit the exactness traps of the kernel (``kernels/csrc/select.cu``):
plateaus across window edges, equal scores at the K-th place, fewer
candidates than K (the fill slots' coordinates), K = H W, a padding tile,
edge tiles of valid extent 1 and 151, and a negative threshold.  The kernel
runs only on the card; ``chip_smoke.py --select`` holds it against the twin
there.  ~12 s in one process (the reference runs op by op).
"""
import os

import numpy as np
import pytest
import torch

from repro.core import nms as jnms
from repro_torch.core import nms
from repro_torch.kernels import ops
from repro_torch.kernels import select as sel

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

HALO = 4


def plateaus(rng, n, h, w):
    """Quarter levels with 5 x 5 plateaus laid across the owned edge, the
    32 x 64 block edges of the kernel's first pass and the map's border."""
    m = (rng.randint(0, 4, (n, h, w)) / 4.0).astype(np.float32)
    for y, x in ((HALO - 2, HALO - 2), (HALO + 30, 10), (20, HALO + 62),
                 (h - 3, w - 3)):
        m[:, max(y, 0):y + 5, max(x, 0):x + 5] = 1.0
    return m


def ties_at_k(rng, n, h, w):
    """Isolated maxima of two levels on a lattice of step 3: more of the
    upper level than K, so the K-th place falls among equal scores."""
    m = np.zeros((n, h, w), np.float32)
    m[:, ::3, ::3] = 0.5
    m[:, ::3, ::6] = 0.75
    return m


def sparse(rng, n, h, w):
    """A handful of peaks: fewer candidates than K, the rest fill slots."""
    m = (rng.rand(n, h, w) * 0.1).astype(np.float32)
    for i in range(n):
        for _ in range(5):
            m[i, rng.randint(h), rng.randint(w)] = 0.9 + 0.01 * i
    return m


def shifted(rng, n, h, w):
    """Plateaus around 0: with a negative threshold every owned pixel that
    NMS does not keep passes with score 0, ranked by index."""
    return plateaus(rng, n, h, w) - np.float32(0.5)


def header(vh, vw, pad=0):
    return [0, 0, 0, vh, vw, pad]


STD = [header(28, 28), header(28, 28, pad=1), header(1, 28), header(17, 5)]
EDGE = [header(1, 151), header(151, 1), header(151, 151), header(0, 151)]

# (maps, shape [n, h, w], headers, k, threshold)
CASES = {
    "plateaus": (plateaus, (4, 36, 36), STD, 20, 0.3),
    "plateaus at threshold 0": (plateaus, (4, 36, 36), STD, 40, 0.0),
    "ties at the K-th place": (ties_at_k, (4, 36, 36), STD, 10, 0.1),
    "fewer candidates than K": (sparse, (4, 36, 36), STD, 100, 0.5),
    "K = H W": (plateaus, (4, 36, 36), STD, 36 * 36, 0.3),
    "K = 1": (plateaus, (4, 36, 36), STD, 1, 0.3),
    "negative threshold": (shifted, (4, 36, 36), STD, 300, -0.3),
    "negative threshold, K = H W": (shifted, (4, 36, 36), STD, 36 * 36, -1.0),
    "edge extents 1 and 151": (plateaus, (4, 160, 160), EDGE, 64, 0.3),
}


def reference(resp, hdr, k, thr):
    """The JAX reference's selection of one tile."""
    mask = jnms.interior_mask(resp.shape, HALO, hdr[3], hdr[4]) & (hdr[5] == 0)
    count = jnms.count_above(resp, thr, mask)
    return (count,) + tuple(jnms.topk_keypoints(jnms.nms3x3(resp), k, thr,
                                                mask))


@pytest.mark.parametrize("case", list(CASES))
def test_selection_matches_reference(case):
    make, shape, hdrs, k, thr = CASES[case]
    maps = make(np.random.RandomState(len(case)), *shape)
    headers = torch.tensor(hdrs, dtype=torch.int32)
    got = ops.select_keypoints(torch.from_numpy(maps), headers, k=k,
                               threshold=thr, halo=HALO)
    assert [t.dtype for t in got] == [torch.int32, torch.int32, torch.int32,
                                      torch.float32, torch.bool]
    assert got[1].shape == (shape[0], min(k, shape[1] * shape[2]))
    for i in range(shape[0]):
        want = reference(maps[i], np.asarray(hdrs[i]), k, thr)
        assert int(got[0][i]) == int(want[0])
        for g, w in zip(got[1:], want[1:]):
            w = np.asarray(w)
            assert g[i].numpy().dtype == w.dtype
            np.testing.assert_array_equal(g[i].numpy(), w)
        if hdrs[i][5]:
            assert int(got[0][i]) == 0 and not got[4][i].any()


def test_fill_slots_are_the_smallest_non_candidates():
    """Fewer candidates than K: after the candidates, the slots hold the
    flat indices that are not candidates, in ascending order, invalid."""
    maps = sparse(np.random.RandomState(3), 2, 36, 36)
    headers = torch.tensor([header(28, 28), header(28, 28)], dtype=torch.int32)
    count, ys, xs, scores, valid = ops.select_keypoints(
        torch.from_numpy(maps), headers, k=200, threshold=0.5, halo=HALO)
    for i in range(2):
        n = int(valid[i].sum())
        idx = (ys[i] * 36 + xs[i]).tolist()
        cand = set(idx[:n])
        assert idx[n:] == [j for j in range(36 * 36) if j not in cand][:200 - n]
        assert not scores[i, n:].any()


def test_scratch_bound_holds_and_is_reached():
    """With a threshold >= 0 the candidates of a tile never exceed
    ``scratch_per_tile``; a lattice of isolated maxima on every other pixel
    of the owned square reaches it."""
    h = w = 36
    m = np.zeros((1, h, w), np.float32)
    m[0, ::2, ::2] = 1.0
    headers = torch.tensor([header(h - HALO, w - HALO)], dtype=torch.int32)
    bound = sel.scratch_per_tile(h, w, HALO, 0.0)
    _, _, _, _, valid = ops.select_keypoints(torch.from_numpy(m), headers,
                                             k=h * w, threshold=0.0, halo=HALO)
    assert int(valid.sum()) == bound == ((h - HALO + 1) // 2) ** 2
    for make in (plateaus, ties_at_k, sparse):
        maps = make(np.random.RandomState(0), 4, h, w)
        _, _, _, _, valid = ops.select_keypoints(
            torch.from_numpy(maps), torch.tensor(STD, dtype=torch.int32),
            k=h * w, threshold=0.0, halo=HALO)
        assert int(valid.sum(1).max()) <= bound
    assert sel.scratch_per_tile(h, w, HALO, -0.5) == (h - HALO) * (w - HALO)


def test_engine_routes_select_the_same():
    """The engine's kernel route (the wrapper, its twin on the CPU) and its
    plain route (the twin directly) give the same fields."""
    maps = torch.from_numpy(plateaus(np.random.RandomState(5), 4, 36, 36))
    headers = torch.tensor(STD, dtype=torch.int32)
    a = ops.select_keypoints(maps, headers, k=30, threshold=0.3, halo=HALO)
    b = nms.select_keypoints(maps, headers, 30, 0.3, HALO)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_wrapper_raises_on_dtype_rank_and_contiguity():
    maps = torch.zeros(2, 12, 12)
    hdr = torch.tensor([header(4, 4)] * 2, dtype=torch.int32)
    kw = dict(k=4, threshold=0.0, halo=HALO)
    with pytest.raises(TypeError):
        ops.select_keypoints(maps.double(), hdr, **kw)
    with pytest.raises(TypeError):
        ops.select_keypoints(maps, hdr.long(), **kw)
    with pytest.raises(ValueError):
        ops.select_keypoints(maps[0], hdr, **kw)
    with pytest.raises(ValueError):
        ops.select_keypoints(maps, hdr[0], **kw)
    with pytest.raises(ValueError):
        ops.select_keypoints(maps.transpose(1, 2), hdr, **kw)
    with pytest.raises(ValueError):
        ops.select_keypoints(maps, torch.zeros(6, 2, dtype=torch.int32).t(),
                             **kw)


def test_cpu_call_launches_nothing():
    ops.reset_launch_counts()
    maps = torch.from_numpy(plateaus(np.random.RandomState(0), 4, 36, 36))
    ops.select_keypoints(maps, torch.tensor(STD, dtype=torch.int32), k=8,
                         threshold=0.3, halo=HALO)
    assert ops.launch_counts()["select"] == 0
