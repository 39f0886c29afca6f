"""Brute-force descriptor matcher: per query, the best and second-best
distance over a masked database and the index of the best.

Port of ``repro/kernels/matcher.py``.  One CUDA kernel (``csrc/matcher.cu``)
replaces both its Pallas kernels, ``match_kernel`` and ``stream_kernel``:
``match`` cuts the queries into ``QBLOCK`` tiles and the database into
segments, enough (tile, segment) blocks to fill the card.  A single segment
scans the whole database per tile (the resident form); with more, a second
small launch merges the segments' partial triples in database order.

On a CUDA tensor ``match`` launches the kernel; on a CPU tensor it runs its
plain twin ``best2_scan``.  ``best2_full`` and ``best2_stream`` are the plain
routes ``ops.match_best2`` takes as ``torch_full`` and ``torch_stream``.

Distances: Hamming over bit-packed words (int32 in the port, the
reference's uint32 layout) is XOR plus popcount, exact int32; L2 ranks on
``|k|^2 - 2 q.k`` and adds ``|q|^2`` once at the end.  Masked rows are BIG
(``1 << 30``, or ``+inf`` for L2).  Ties go to the smallest database index:
first-occurrence argmin inside a chunk and a strictly-less merge across
chunks in database order, so every path gives the same (best, second, idx).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel
from repro_torch.kernels.ref import BIG_HAMMING, best2_rows

QBLOCK = 128              # queries per block (csrc/matcher.cu QT)
SEGMENT_ALIGN = 64        # segments are whole kernel chunks (CH)
MAX_WORDS = 16            # Hamming words the kernel holds per query
MAX_DIM = 128             # L2 dimensions the kernel holds per query
BLOCKS_PER_SM = 8         # aim for this many blocks per SM


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
    ctypes.c_void_p,                                         # |k|^2 scratch
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,       # best, second, idx
    ctypes.c_int, ctypes.c_int,                              # seg_rows, n_seg
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])      # partials


def check_match_inputs(q, db, db_valid, metric, name):
    """What the matcher wrappers take: contiguous [Q, W] int32 words
    (Hamming) or [Q, D] float32 (L2), the same width in ``db`` [K, ·], and
    ``db_valid`` int32 [K], all on one CPU or CUDA device."""
    _check_metric(metric)
    want = dist_dtype(metric)
    if q.dtype != want or db.dtype != want:
        raise TypeError(f"{name}: {metric} needs {want} queries and database, "
                        f"got {q.dtype} and {db.dtype}")
    if q.ndim != 2 or db.ndim != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(f"{name}: needs [Q, D] and [K, D], got "
                         f"{tuple(q.shape)} and {tuple(db.shape)}")
    if db_valid.dtype != torch.int32 or db_valid.shape != (db.shape[0],):
        raise ValueError(f"{name}: db_valid must be int32 [K]")
    if not (q.is_contiguous() and db.is_contiguous()
            and db_valid.is_contiguous()):
        raise ValueError(f"{name}: needs contiguous tensors")
    if len({q.device, db.device, db_valid.device}) != 1:
        raise ValueError(f"{name}: inputs on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: runs on cpu or cuda, not {q.device}")
    width = q.shape[1]
    limit = MAX_WORDS if metric == "hamming" else MAX_DIM
    if q.device.type == "cuda" and not 1 <= width <= limit:
        raise ValueError(f"{name}: the kernel takes 1..{limit} "
                         f"{'words' if metric == 'hamming' else 'dims'}, "
                         f"got {width}")


def _outputs(nq, metric, device):
    dt = dist_dtype(metric)
    return (torch.empty(nq, dtype=dt, device=device),
            torch.empty(nq, dtype=dt, device=device),
            torch.empty(nq, dtype=torch.int32, device=device))


def segments(nq: int, nk: int, n_sm: int):
    """(rows per segment, segments) of one launch: enough (query tile,
    segment) blocks for ``BLOCKS_PER_SM`` per SM, each segment a whole
    number of kernel chunks.  Once the query tiles alone fill the card this
    is a single segment, and the launch needs no merge."""
    q_tiles = max(1, -(-nq // QBLOCK))
    want = max(1, -(-BLOCKS_PER_SM * n_sm // q_tiles))
    rows = max(SEGMENT_ALIGN, -(-nk // want))
    rows = -(-rows // SEGMENT_ALIGN) * SEGMENT_ALIGN
    return rows, max(1, -(-nk // rows))


def match(q, db, db_valid, *, metric: str):
    """The matcher kernel: queries in ``QBLOCK`` tiles, the database in
    ``segments``, the partial triples merged in database order.
    -> (best [Q], second [Q], idx [Q] int32)."""
    check_match_inputs(q, db, db_valid, metric, "match")
    if q.device.type == "cpu":
        return best2_scan(q, db, db_valid, metric=metric)
    nq, nk = q.shape[0], db.shape[0]
    if nq >= 2 ** 31 or nk >= 2 ** 31:
        raise ValueError("match: 2^31 rows or more")
    out = _outputs(nq, metric, q.device)
    if nq == 0:
        return out
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    seg_rows, n_seg = segments(nq, nk, n_sm)
    parts = _outputs(n_seg * nq if n_seg > 1 else 0, metric, q.device)
    dn = torch.empty(nk if metric == "l2" else 0, dtype=torch.float32,
                     device=q.device)
    KERNEL.launch(q.device, q.data_ptr(), db.data_ptr(), db_valid.data_ptr(),
                  nq, nk, q.shape[1], int(metric == "l2"), dn.data_ptr(),
                  *(o.data_ptr() for o in out), seg_rows, n_seg,
                  *(p.data_ptr() for p in parts))
    return out
