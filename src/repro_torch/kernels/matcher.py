"""Brute-force descriptor matcher: per query, the best and second-best
distance over a masked database and the index of the best.

Port of ``repro/kernels/matcher.py``.  One CUDA kernel (``csrc/matcher.cu``)
replaces both its Pallas kernels, ``match_kernel`` and ``stream_kernel``,
with one launch per call: ``match`` cuts the queries into ``QBLOCK`` tiles
and the database into the ``plan``'s segments, enough (tile, segment)
blocks for one wave on the card: segment g of n holds the ``WINDOW``-row
windows g, g + n, g + 2 n, ..., so that a database whose valid rows come
first (a top-K list) still spreads its work over every segment.  Each block
compacts its segment's valid rows in order and scans them in chunks; with
several segments the last block of a query tile to finish merges the
tile's partial triples.

On a CUDA tensor ``match`` launches the kernel; on a CPU tensor it runs its
plain twin ``best2_scan``.  ``best2_full`` and ``best2_stream`` are the plain
routes ``ops.match_best2`` takes as ``torch_full`` and ``torch_stream``.

Distances: Hamming over bit-packed words (int32 in the port, the
reference's uint32 layout) is XOR plus popcount, exact int32; L2 ranks on
``|k|^2 - 2 q.k`` and adds ``|q|^2`` once at the end.  Masked rows are BIG
(``1 << 30``, or ``+inf`` for L2).  Ties go to the smallest database index:
the twins take the first-occurrence argmin inside a chunk and merge chunks
in database order with a strictly-less rule (``_merge_best2``); the kernel
merges its threads and segments in any order with the lexicographic rule on
(distance, index) (``merge_best2``), which gives the same triple.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import CudaKernel, load
from repro_torch.kernels.ref import BIG_HAMMING, best2_rows

QBLOCK = 128              # queries per block (csrc/matcher.cu BQ)
WINDOW = 64               # rows per window dealt to the segments (WIN)
MIN_SEGMENT_ROWS = 256    # rows per segment, where the database has them
MAX_WORDS = 16            # Hamming words the kernel takes per descriptor
MAX_DIM = 128             # L2 dimensions the kernel takes per descriptor


def kchunk_for(metric: str) -> int:
    """Database rows per chunk of ``best2_scan`` (the resident twin)."""
    return 256 if metric == "hamming" else 1024


def kblock_for(metric: str) -> int:
    """Database rows per chunk of ``best2_stream`` (the streaming twin)."""
    return 512 if metric == "hamming" else 2048


def big_for(metric: str):
    """The masked/initial distance: above any real distance, exact in the
    metric's dtype (int32 Hamming, fp32 +inf for L2)."""
    return BIG_HAMMING if metric == "hamming" else float("inf")


def dist_dtype(metric: str) -> torch.dtype:
    return torch.int32 if metric == "hamming" else torch.float32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of 32-bit words held as int32.

    The reference's SWAR count relies on uint32 wrap-around; on int32 words
    ``>>`` sign-extends and the byte-sum multiply overflows, so this counts
    in int64 on the word's low 32 bits.  Returns int64 counts (0..32)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _chunk_dist(q, c, m, metric, big, dn=None):
    """Distances of one database chunk [Q, C], masked slots set to big.
    L2 leaves out |q|^2 (callers add it once at the end); ``dn`` is a
    precomputed |k|^2."""
    if metric == "hamming":
        d = popcount32(q[:, None, :] ^ c[None, :, :]).sum(dim=-1) \
            .to(torch.int32)
    else:
        dot = q @ c.T
        dn = (c * c).sum(dim=-1) if dn is None else dn
        d = dn[None, :] - 2.0 * dot
    return torch.where(m[None, :] != 0, d, torch.full_like(d, big))


def _chunk_best2(d, start, big):
    """Best/second/argbest of one [Q, C] chunk; indices global."""
    best, second, arg = best2_rows(d, big)
    return best, second, arg + start


def _merge_best2(carry, chunk):
    """Merge a chunk's (best, second, idx) into the carried triple.  The
    strictly-less ``take`` keeps the earlier winner on ties, so merging in
    database order fixes the tie-break."""
    best, second, bidx = carry
    cb, cs, ci = chunk
    take = cb < best
    second = torch.where(take, torch.minimum(best, cs),
                         torch.minimum(second, cb))
    bidx = torch.where(take, ci, bidx)
    best = torch.where(take, cb, best)
    return best, second, bidx


def merge_best2(a, b):
    """Merge two triples over disjoint sets of rows, in either order: the
    lexicographic rule on (distance, index) of the kernel's merge across
    threads and segments.  ``take`` also breaks a tied distance toward the
    smaller index, so the result is the in-order ``_merge_best2``'s for
    any partition of the database."""
    best, second, bidx = a
    cb, cs, ci = b
    take = (cb < best) | ((cb == best) & (ci < bidx))
    second = torch.where(take, torch.minimum(best, cs),
                         torch.minimum(second, cb))
    bidx = torch.where(take, ci, bidx)
    best = torch.where(take, cb, best)
    return best, second, bidx


def _l2_qnorm(q, best, second):
    """Fold |q|^2 into the scanned partial distances (+inf absorbs it)."""
    qn = (q * q).sum(dim=-1)
    return best + qn, second + qn


def _init(nq, metric, device):
    big = big_for(metric)
    dt = dist_dtype(metric)
    return (torch.full((nq,), big, dtype=dt, device=device),
            torch.full((nq,), big, dtype=dt, device=device),
            torch.zeros(nq, dtype=torch.int32, device=device))


def _check_metric(metric):
    if metric not in ("hamming", "l2"):
        raise ValueError(f"unknown metric {metric!r}")


def _scan(q, db, db_valid, metric, kchunk, dn=None):
    carry = _init(q.shape[0], metric, q.device)
    big = big_for(metric)
    for start in range(0, db.shape[0], kchunk):
        sl = slice(start, start + kchunk)
        d = _chunk_dist(q, db[sl], db_valid[sl], metric, big,
                        dn=None if dn is None else dn[sl])
        carry = _merge_best2(carry, _chunk_best2(d, start, big))
    best, second, bidx = carry
    if metric == "l2":
        best, second = _l2_qnorm(q, best, second)
    return best, second, bidx


def best2_scan(q, db, db_valid, *, metric: str, kchunk: int = None):
    """Running best/second-best over ``kchunk_for(metric)`` chunks, |k|^2
    computed once: the kernel's plain twin.  q [Q, D], db [K, D],
    db_valid [K] -> (best [Q], second [Q], idx [Q] int32)."""
    _check_metric(metric)
    dn = (db * db).sum(dim=-1) if metric == "l2" else None
    return _scan(q, db, db_valid, metric,
                 kchunk_for(metric) if kchunk is None else kchunk, dn)


def best2_full(q, db, db_valid, *, metric: str):
    """One block: the whole [Q, K] distance matrix at once."""
    _check_metric(metric)
    if db.shape[0] == 0:
        return _scan(q, db, db_valid, metric, 1)
    big = big_for(metric)
    best, second, bidx = _chunk_best2(_chunk_dist(q, db, db_valid, metric,
                                                  big), 0, big)
    if metric == "l2":
        best, second = _l2_qnorm(q, best, second)
    return best, second, bidx


def best2_stream(q, db, db_valid, *, metric: str, kchunk: int = None):
    """The reference's ``lax.scan`` over ``kblock_for(metric)`` chunks
    written as a loop (|k|^2 per chunk).  A
    ragged tail chunk is simply shorter; the reference's zero-padded rows
    are masked, so they never change the result."""
    _check_metric(metric)
    return _scan(q, db, db_valid, metric,
                 kblock_for(metric) if kchunk is None else kchunk)


# --- the CUDA kernel's wrapper -------------------------------------------------
KERNEL = CudaKernel("matcher", "difet_match", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,       # q, db, valid
    ctypes.c_int, ctypes.c_int, ctypes.c_int,                # nq, nk, width
    ctypes.c_int,                                            # metric (1 = l2)
    ctypes.c_void_p,                                         # out [3, nq]
    ctypes.c_int,                                            # segments
    ctypes.c_void_p])                                        # scratch


def check_shapes(q, db, db_valid, metric, name):
    """What every route to the kernel needs beyond dtypes and contiguity:
    [Q, D] queries and [K, D] rows of one width (1..``MAX_WORDS`` words or
    1..``MAX_DIM`` dimensions on the card), ``db_valid`` [K], all on one
    CPU or CUDA device."""
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"{name}: needs [Q, D] and [K, D], got "
                         f"{tuple(q.shape)} and {tuple(db.shape)}")
    if db_valid.shape != (db.shape[0],):
        raise ValueError(f"{name}: db_valid must be int32 [K]")
    if q.shape[0] >= 2 ** 31 or db.shape[0] >= 2 ** 31 - 1024:
        raise ValueError(f"{name}: 2^31 rows or more")
    dev = q.get_device()
    if db.get_device() != dev or db_valid.get_device() != dev:
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda, not {q.device}")
    width = q.shape[1]
    limit = MAX_WORDS if metric == "hamming" else MAX_DIM
    if dev >= 0 and not 1 <= width <= limit:
        raise ValueError(f"{name}: the kernel takes 1..{limit} "
                         f"{'words' if metric == 'hamming' else 'dims'}, "
                         f"got {width}")


def check_match_inputs(q, db, db_valid, metric, name):
    """What the matcher wrappers take: contiguous [Q, W] int32 words
    (Hamming) or [Q, D] float32 (L2), the same width in ``db`` [K, ·], and
    ``db_valid`` int32 [K], all on one CPU or CUDA device."""
    _check_metric(metric)
    want = dist_dtype(metric)
    if q.dtype != want or db.dtype != want:
        raise TypeError(f"{name}: {metric} needs {want} queries and database, "
                        f"got {q.dtype} and {db.dtype}")
    if db_valid.dtype != torch.int32:
        raise ValueError(f"{name}: db_valid must be int32 [K]")
    if not (q.is_contiguous() and db.is_contiguous()
            and db_valid.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous tensors")
    check_shapes(q, db, db_valid, metric, name)


def plan(nq: int, nk: int, slots: int) -> int:
    """Segments of one launch over ``nq`` queries and ``nk`` rows, where
    ``slots`` blocks of the metric's kernel fit on the card at once.

    The (query tile, segment) blocks make at most one wave; every segment
    gets ``MIN_SEGMENT_ROWS // WINDOW`` windows or more (several chunks),
    so that blocks live long; once the query tiles alone fill half the card
    or more this is a single segment, whose blocks write the final triples
    with no merge."""
    tiles = -(-nq // QBLOCK)
    return max(1, min(slots // max(tiles, 1), nk // MIN_SEGMENT_ROWS))


@functools.lru_cache(maxsize=None)
def slots(index: int, metric: str, width: int) -> int:
    """Blocks of the kernel for ``metric`` at ``width`` that CUDA device
    ``index`` holds at once: its SM count times the blocks an SM holds
    (the kernel's own occupancy at its shared memory and registers)."""
    fn = load(KERNEL.source).difet_match_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(int(metric == "l2"), width, ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"difet_match_blocks_per_sm: CUDA error {rc}, "
                           f"{per_sm.value} blocks per SM")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * per_sm.value


def launch(q, db, db_valid, *, metric: str):
    """The kernel on inputs that ``check_match_inputs`` accepts (CPU tensors:
    its twin ``best2_scan``): one launch, one output allocation, and with
    several segments one scratch allocation and one memset of its tickets.
    -> (best [Q], second [Q], idx [Q] int32), views of one [3, Q] tensor."""
    if not q.is_cuda:
        return best2_scan(q, db, db_valid, metric=metric)
    nq, width = q.shape
    nk = db.shape[0]
    dev = q.device
    out = torch.empty((3, nq), dtype=torch.int32, device=dev)
    if nq:
        n_seg = plan(nq, nk, slots(dev.index, metric, width))
        scratch = 0
        if n_seg > 1:
            part = torch.empty(-(-nq // QBLOCK) + 3 * n_seg * nq,
                               dtype=torch.int32, device=dev)
            scratch = part.data_ptr()
        KERNEL.launch(dev, q.data_ptr(), db.data_ptr(), db_valid.data_ptr(),
                      nq, nk, width, int(metric == "l2"), out.data_ptr(),
                      n_seg, scratch)
    best, second, idx = out
    if metric == "l2":
        return best.view(torch.float32), second.view(torch.float32), idx
    return best, second, idx


def match(q, db, db_valid, *, metric: str):
    """The matcher kernel, inputs checked: queries in ``QBLOCK`` tiles, the
    database in the segments of ``plan``, each block's valid rows compacted
    in order and merged lexicographically on (distance, index).
    -> (best [Q], second [Q], idx [Q] int32)."""
    check_match_inputs(q, db, db_valid, metric, "match")
    return launch(q, db, db_valid, metric=metric)
