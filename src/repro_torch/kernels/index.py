"""Approximate pre-filter indexes for the matcher: multi-probe LSH over
packed Hamming bits (BRIEF/ORB) and a small k-means vocabulary with
inverted lists for L2 (SIFT/SURF).

Port of ``repro/kernels/index.py``; plain array code there and here, not a
kernel.  An index cuts the scored set to a few hundred candidates per query
and re-ranks them with the exact metric (``rerank_exact``), so an
approximate match is a real (best, second, argbest) over its candidates,
with the exact paths' masking and smallest-index ties; the only
approximation is recall.

Construction is host-side numpy, the same arithmetic as the reference's,
so a port index built from the same database holds the same tables; the
search is torch on the database's device.  ``convert.lsh_from_reference``
and ``convert.kmeans_from_reference`` build one from a reference index's
state instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.nms import stable_topk
from repro_torch.kernels import matcher as _matcher

_RERANK_CHUNK = 128     # candidate columns scored per slab in rerank


def default_bits(nk: int) -> int:
    """Hash width for an ``nk``-row database: about log2(nk), in [6, 16]."""
    return int(np.clip(int(np.ceil(np.log2(max(nk, 2)))), 6, 16))


def rerank_exact(q, db, db_valid, cand, *, metric: str):
    """Exact best/second/argbest over per-query candidate sets.

    q [Q, D], db [K, D], db_valid [K], cand [Q, C] int32 database indices
    (< 0 = empty) -> (best [Q], second [Q], idx [Q] int32).  Candidates are
    sorted per row so that duplicates (one row from several tables or
    probes) are masked, and so that the first minimum is the smallest
    index; slabs of ``_RERANK_CHUNK`` columns bound the temporaries."""
    big = _matcher.big_for(metric)
    nq, nc = cand.shape
    cand = torch.sort(cand, dim=1).values            # -1s first, dups adjacent
    dup = torch.cat([torch.zeros(nq, 1, dtype=torch.bool, device=cand.device),
                     cand[:, 1:] == cand[:, :-1]], dim=1)
    safe = cand.clamp_min(0).long()
    ok = (cand >= 0) & ~dup & (db_valid[safe] != 0)
    carry = _matcher._init(nq, metric, q.device)
    for s in range(0, nc, _RERANK_CHUNK):
        csl = safe[:, s:s + _RERANK_CHUNK]
        rows = db[csl]                                # [Q, c, D]
        if metric == "hamming":
            d = _matcher.popcount32(q[:, None, :] ^ rows).sum(dim=-1) \
                .to(torch.int32)
        else:
            diff = q[:, None, :].float() - rows.float()
            d = (diff * diff).sum(dim=-1)
        d = torch.where(ok[:, s:s + _RERANK_CHUNK], d, torch.full_like(d, big))
        cb, cs, arg = _matcher._chunk_best2(d, 0, big)
        ci = torch.gather(csl, 1, arg[:, None].long())[:, 0].to(torch.int32)
        carry = _matcher._merge_best2(carry, (cb, cs, ci))
    return carry


def _as_words_np(db) -> np.ndarray:
    """Packed words as uint32 numpy (the reference's layout), from int32
    tensors or arrays, or uint32 arrays."""
    a = db.cpu().numpy() if isinstance(db, torch.Tensor) else np.asarray(db)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    if a.dtype != np.uint32:
        raise TypeError("LshIndex needs bit-packed int32 descriptors "
                        "(descriptors.pack_bits layout)")
    return a


def _device_of(db):
    """Indexes live where their database lives (numpy: the CPU)."""
    return db.device if isinstance(db, torch.Tensor) else torch.device("cpu")


def _valid_np(db_valid, nk) -> np.ndarray:
    if db_valid is None:
        return np.ones(nk, bool)
    v = db_valid.cpu().numpy() if isinstance(db_valid, torch.Tensor) \
        else np.asarray(db_valid)
    return v.astype(bool)


class LshIndex:
    """Multi-probe LSH over bit-packed binary descriptors.

    ``n_tables`` tables hash ``n_bits`` sampled bit positions each; a query
    probes its own bucket and ``probes - 1`` single-bit flips of it.  Lists
    hold ``bucket_cap`` rows; rows beyond it are dropped from that table
    (counted in ``overflow``)."""

    metric = "hamming"

    def __init__(self, db, db_valid=None, *, n_tables: int = 8,
                 n_bits: Optional[int] = None,
                 bucket_cap: Optional[int] = None,
                 probes: Optional[int] = None, seed: int = 0):
        words = _as_words_np(db)
        nk, n_words = words.shape
        valid = _valid_np(db_valid, nk)
        n_bits = default_bits(nk) if n_bits is None else int(n_bits)
        if bucket_cap is None:
            bucket_cap = max(8, int(4 * np.ceil(nk / 2 ** n_bits)))
        rng = np.random.RandomState(seed)
        pos = np.stack([rng.choice(n_words * 32, n_bits, replace=False)
                        for _ in range(int(n_tables))])
        word = (pos // 32).astype(np.int32)
        shift = (pos % 32).astype(np.uint32)
        lists = np.full((int(n_tables), 2 ** n_bits, int(bucket_cap)), -1,
                        np.int32)
        codes = self._codes_np(words, word, shift, n_bits)      # [T, K]
        overflow = 0
        rows = np.nonzero(valid)[0]
        for t in range(int(n_tables)):
            # fill in database order: stable sort by bucket, rank in bucket
            c = codes[t, rows]
            order = np.argsort(c, kind="stable")
            cs, rs = c[order], rows[order]
            first = np.concatenate([[True], cs[1:] != cs[:-1]])
            pos_in = np.arange(len(cs)) - \
                np.maximum.accumulate(np.where(first, np.arange(len(cs)), 0))
            keep = pos_in < bucket_cap
            overflow += int((~keep).sum())
            lists[t, cs[keep], pos_in[keep]] = rs[keep]
        self._setup(db, valid, word, shift, lists, probes)
        self.overflow = overflow

    @classmethod
    def from_state(cls, db, db_valid, word, shift, lists,
                   probes: Optional[int] = None) -> "LshIndex":
        """An index from given hash positions (``word``, ``shift`` [T, B])
        and inverted lists [T, 2^B, cap]."""
        self = cls.__new__(cls)
        words = _as_words_np(db)
        self._setup(db, _valid_np(db_valid, words.shape[0]),
                    np.asarray(word, np.int32), np.asarray(shift, np.uint32),
                    np.asarray(lists, np.int32), probes)
        self.overflow = 0
        return self

    def _setup(self, db, valid, word, shift, lists, probes):
        words = _as_words_np(db)
        device = _device_of(db)
        self.n_tables, self.n_bits = word.shape
        self.bucket_cap = lists.shape[2]
        self.probes = self.n_bits + 1 if probes is None else int(probes)
        self.n_rows = int(words.shape[0])
        self._word, self._shift = word, shift
        self._db = torch.from_numpy(words.view(np.int32).copy()).to(device)
        self._valid = torch.from_numpy(valid.copy()).to(device)
        self._lists = torch.from_numpy(lists.copy()).to(device)
        self._wordt = torch.from_numpy(word.astype(np.int64)).to(device)
        self._shiftt = torch.from_numpy(shift.astype(np.int32)).to(device)

    @staticmethod
    def _codes_np(x, word, shift, n_bits) -> np.ndarray:
        bits = (x[:, word] >> shift) & np.uint32(1)             # [N, T, B]
        weights = np.uint32(1) << np.arange(n_bits, dtype=np.uint32)
        return bits.astype(np.uint32).dot(weights).T.astype(np.int32)

    def _codes(self, q) -> torch.Tensor:
        bits = (q[:, self._wordt] >> self._shiftt) & 1           # [Q, T, B]
        weights = 1 << torch.arange(self.n_bits, device=q.device,
                                    dtype=torch.int64)
        return (bits.to(torch.int64) * weights).sum(dim=-1) \
            .to(torch.int32).T                                  # [T, Q]

    def candidates(self, q, probes: Optional[int] = None) -> torch.Tensor:
        """Candidate database indices per query: [Q, T*probes*cap] int32,
        -1 for empty slots; duplicates possible (the re-rank drops them)."""
        probes = self.probes if probes is None else int(probes)
        probes = min(probes, self.n_bits + 1)
        codes = self._codes(q)                                  # [T, Q]
        flips = torch.cat([
            torch.zeros(1, dtype=torch.int32, device=q.device),
            1 << torch.arange(probes - 1, dtype=torch.int32, device=q.device)])
        probed = codes[:, :, None] ^ flips[None, None, :]       # [T, Q, P]
        tbl = torch.arange(self.n_tables, device=q.device)[:, None, None]
        cand = self._lists[tbl, probed.long()]                  # [T, Q, P, cap]
        return cand.movedim(0, 1).reshape(q.shape[0], -1)

    def search(self, q, probes: Optional[int] = None):
        """Approximate (best, second, idx) for q [Q, W] int32 words."""
        return rerank_exact(q, self._db, self._valid,
                            self.candidates(q, probes), metric=self.metric)


class KMeansIndex:
    """k-means vocabulary and inverted lists for float (L2) descriptors.
    A few Lloyd iterations over the valid rows; every row lives in one
    centroid's list; a query scans its ``probes`` nearest lists."""

    metric = "l2"

    def __init__(self, db, db_valid=None, *, n_clusters: Optional[int] = None,
                 iters: int = 8, bucket_cap: Optional[int] = None,
                 probes: int = 8, seed: int = 0):
        a = db.cpu().numpy() if isinstance(db, torch.Tensor) else db
        a = np.asarray(a, np.float32)
        nk = a.shape[0]
        valid = _valid_np(db_valid, nk)
        rows = np.nonzero(valid)[0]
        pts = a[rows] if len(rows) else a[:1]
        if n_clusters is None:
            n_clusters = int(np.clip(int(np.sqrt(max(len(pts), 1))), 4, 1024))
        n_clusters = min(int(n_clusters), max(len(pts), 1))
        rng = np.random.RandomState(seed)
        cent = pts[rng.choice(len(pts), n_clusters,
                              replace=len(pts) < n_clusters)].copy()
        for _ in range(int(iters)):
            d2 = (np.sum(pts * pts, 1)[:, None]
                  + np.sum(cent * cent, 1)[None, :] - 2.0 * pts @ cent.T)
            assign = np.argmin(d2, axis=1)
            for c in range(n_clusters):
                m = assign == c
                if m.any():
                    cent[c] = pts[m].mean(axis=0)
        d2 = (np.sum(pts * pts, 1)[:, None]
              + np.sum(cent * cent, 1)[None, :] - 2.0 * pts @ cent.T)
        assign = np.argmin(d2, axis=1)
        if bucket_cap is None:
            counts = np.bincount(assign, minlength=n_clusters)
            bucket_cap = max(8, int(counts.max())) if len(pts) else 8
        lists = np.full((n_clusters, int(bucket_cap)), -1, np.int32)
        fill = np.zeros(n_clusters, np.int32)
        overflow = 0
        for i, c in zip(rows, assign):                  # database order
            if fill[c] < bucket_cap:
                lists[c, fill[c]] = i
                fill[c] += 1
            else:
                overflow += 1
        self._setup(db, valid, cent, lists, probes)
        self.overflow = overflow

    @classmethod
    def from_state(cls, db, db_valid, centroids, lists,
                   probes: int = 8) -> "KMeansIndex":
        """An index from given centroids [C, D] and lists [C, cap]."""
        self = cls.__new__(cls)
        a = db.cpu().numpy() if isinstance(db, torch.Tensor) else db
        self._setup(db, _valid_np(db_valid, np.asarray(a).shape[0]),
                    np.asarray(centroids, np.float32),
                    np.asarray(lists, np.int32), probes)
        self.overflow = 0
        return self

    def _setup(self, db, valid, cent, lists, probes):
        device = _device_of(db)
        a = db.cpu().numpy() if isinstance(db, torch.Tensor) else db
        a = np.asarray(a, np.float32)
        self.n_clusters = cent.shape[0]
        self.probes = min(int(probes), self.n_clusters)
        self.bucket_cap = lists.shape[1]
        self.n_rows = int(a.shape[0])
        self._db = torch.from_numpy(a.copy()).to(device)
        self._valid = torch.from_numpy(valid.copy()).to(device)
        self._cent = torch.from_numpy(cent.copy()).to(device)
        self._lists = torch.from_numpy(lists.copy()).to(device)

    def candidates(self, q, probes: Optional[int] = None) -> torch.Tensor:
        """Candidate database indices per query: [Q, probes*cap] int32, -1
        for empty slots (lists are disjoint).  Nearest centroids by a stable
        top-k, ties toward the smaller index as ``lax.top_k``."""
        probes = self.probes if probes is None else \
            min(int(probes), self.n_clusters)
        q = q.float()
        d2 = ((q * q).sum(dim=1)[:, None]
              + (self._cent * self._cent).sum(dim=1)[None, :]
              - 2.0 * q @ self._cent.T)
        _, near = stable_topk(-d2, probes)                 # [Q, probes]
        return self._lists[near].reshape(q.shape[0], -1)

    def search(self, q, probes: Optional[int] = None):
        """Approximate (best, second, idx) for q [Q, D] floats: exact-L2
        re-rank over the nearest centroids' lists."""
        return rerank_exact(q.float(), self._db, self._valid,
                            self.candidates(q, probes), metric=self.metric)


def build_index(db, db_valid=None, *, metric: Optional[str] = None,
                **knobs):
    """Packed int32 descriptors (or ``metric="hamming"``) get an
    :class:`LshIndex`, floats a :class:`KMeansIndex`; ``knobs`` go to the
    constructor."""
    if metric is None:
        is_int = (db.dtype == torch.int32 if isinstance(db, torch.Tensor)
                  else np.asarray(db).dtype in (np.int32, np.uint32))
        metric = "hamming" if is_int else "l2"
    if metric == "hamming":
        return LshIndex(db, db_valid, **knobs)
    if metric == "l2":
        return KMeansIndex(db, db_valid, **knobs)
    raise ValueError(f"unknown metric {metric!r}")
