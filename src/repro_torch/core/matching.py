"""Descriptor matching and robust registration.

Port of ``repro/core/matching.py``.  DIFET's per-scene top-K descriptor
sets (fixed shapes plus validity masks, ``core/engine.py``) are paired here:

* ``match_pair``: mutual nearest neighbour plus Lowe's ratio test.
  Distances come from ``kernels/ops.match_best2`` (the CUDA matcher on the
  card); the metric follows the dtype: packed int32 words are Hamming,
  floats squared L2.
* ``estimate_translation`` / ``estimate_similarity``: fixed-iteration
  RANSAC with dense [iters, K] scoring.

RANSAC's uniform draws are an argument (``draws``): ``jax.random`` cannot
be reproduced in torch, so by default they come from a ``torch.Generator``
seeded from (seed, pair index) (``uniform_draws``), and tests hand both
packages the same numbers.

Convention: a model maps scene-a coordinates to scene-b, ``pb ≈ T(pa)``;
for a translation ``t = (dy, dx)``, and with scene origins ``O_a``, ``O_b``
in a common frame ``t = O_a - O_b``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import index as kindex
from repro_torch.kernels import ops as kops

# any real distance is far below this; masked slots are far above it
_MATCHED_CUT = 1e6


class PairMatches(NamedTuple):
    idx_b: torch.Tensor   # [Ka] int32, best database index per query
    ok: torch.Tensor      # [Ka] bool, valid & mutual & ratio-accepted
    dist: torch.Tensor    # [Ka] best distance (int Hamming / squared L2)


class TranslationEstimate(NamedTuple):
    t: torch.Tensor          # [2] (dy, dx): pb ≈ pa + t
    inliers: torch.Tensor    # [K] bool
    n_inliers: torch.Tensor  # int32
    rms: torch.Tensor        # f32, rms inlier residual (px)


class SimilarityEstimate(NamedTuple):
    scale: torch.Tensor      # f32
    theta: torch.Tensor      # f32 radians (x-y plane, counter-clockwise)
    t: torch.Tensor          # [2] (ty, tx)
    inliers: torch.Tensor    # [K] bool
    n_inliers: torch.Tensor  # int32
    rms: torch.Tensor        # f32


def infer_metric(desc: torch.Tensor) -> str:
    """Packed int32 words mean Hamming, floats mean L2; nothing else."""
    if desc.dtype == torch.int32:
        return "hamming"
    if desc.is_floating_point():
        return "l2"
    raise TypeError(f"descriptors must be packed int32 words or floats, "
                    f"got {desc.dtype}")


def _filter_matches(valid_a, best, second, idx, ridx, ratio, metric
                    ) -> PairMatches:
    """Mutual + ratio acceptance shared by the exact and approx modes.  The
    ratio compares squared L2 distances, so its threshold is squared for
    floats; a query whose best and second tie fails the strict test."""
    r = float(np.float32(ratio * ratio if metric == "l2" else ratio))
    ka = idx.shape[0]
    if ridx.shape[0] == 0:                 # empty database: nothing matches
        mutual = torch.zeros(ka, dtype=torch.bool, device=idx.device)
    else:
        mutual = ridx[idx.long()] == torch.arange(ka, dtype=torch.int32,
                                                  device=idx.device)
    bf = best.float()
    sf = second.float()
    matched = bf < _MATCHED_CUT            # all-masked or empty databases
    ok = (valid_a != 0) & mutual & matched & (bf < r * sf)
    return PairMatches(idx, ok, best)


def match_pair(desc_a, valid_a, desc_b, valid_b, ratio: float = 0.8, *,
               metric: Optional[str] = None,
               use_kernels: Optional[bool] = None, mode: str = "exact",
               probes: Optional[int] = None, index_a=None,
               index_b=None) -> PairMatches:
    """Mutual-NN + Lowe ratio matches from set a into set b.

    ``mode="exact"`` scores every database row through
    ``kernels/ops.match_best2`` (``use_kernels`` as there: None or True
    the CUDA kernel on the card, False the torch paths).  ``mode="approx"`` goes
    through the indexes of ``kernels/index.py`` (LSH for packed bits,
    k-means lists for L2) with an exact re-rank of the candidates;
    ``probes`` trades recall for work, and ``index_a``/``index_b`` take
    prebuilt indexes."""
    metric = metric or infer_metric(desc_a)
    if mode == "exact":
        best, second, idx = kops.match_best2(desc_a, desc_b, valid_b,
                                             metric=metric,
                                             use_kernels=use_kernels)
        _, _, ridx = kops.match_best2(desc_b, desc_a, valid_a, metric=metric,
                                      use_kernels=use_kernels)
        return _filter_matches(valid_a, best, second, idx, ridx, ratio,
                               metric)
    if mode != "approx":
        raise ValueError(f"unknown mode {mode!r}")
    if index_b is None:
        index_b = kindex.build_index(desc_b, valid_b, metric=metric)
    if index_a is None:
        index_a = kindex.build_index(desc_a, valid_a, metric=metric)
    best, second, idx = index_b.search(desc_a, probes)
    _, _, ridx = index_a.search(desc_b, probes)
    return _filter_matches(valid_a, best, second, idx, ridx, ratio, metric)


def uniform_draws(shape, seed: int = 0, index: int = 0,
                  device="cpu") -> torch.Tensor:
    """Uniform [0, 1) float32 draws of ``shape`` from a ``torch.Generator``
    seeded from (seed, index): the same numbers on every device and every
    restart."""
    s = int(np.random.SeedSequence([int(seed), int(index)])
            .generate_state(1, np.uint64)[0])
    g = torch.Generator().manual_seed(s)
    return torch.rand(tuple(shape), generator=g).to(device)


def _sample_valid(u: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Indices into the True entries of ``ok`` from uniform draws ``u``
    (inverse CDF by ``searchsorted`` on the running count); arbitrary when
    none is True, which leaves callers with 0 inliers."""
    cum = torch.cumsum(ok.to(torch.int32), 0, dtype=torch.int32)
    n_ok = cum[-1]
    target = torch.floor(u * n_ok.float()).to(torch.int32)
    idx = torch.searchsorted(cum, target, right=True)
    return idx.clamp(0, ok.shape[0] - 1).to(torch.int32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum (``jnp.argmax``)."""
    pos = torch.arange(x.shape[0], device=x.device)
    return torch.where(x == x.max(), pos, x.shape[0]).min()


def _norm2(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis as ``jnp.linalg.norm`` forms it."""
    return torch.sqrt((v * v).sum(dim=-1))


def _finish(resid, okb, tol):
    inl = okb & (resid < tol)
    n = inl.sum().to(torch.int32)
    rms = torch.sqrt(torch.where(inl, resid * resid,
                                 torch.zeros_like(resid)).sum()
                     / torch.clamp_min(n, 1).float())
    return inl, n, rms


def estimate_translation(pa, pb, ok, draws=None, tol: float = 2.0, *,
                         iters: int = 128, seed: int = 0
                         ) -> TranslationEstimate:
    """RANSAC translation: pa, pb [K, 2] (y, x); ok [K] bool.  ``iters``
    one-point hypotheses from the uniform ``draws`` [iters] (default
    ``uniform_draws((iters,), seed)``), scored densely, then the inlier-mean
    offset of the best."""
    if draws is None:
        draws = uniform_draws((iters,), seed, device=pa.device)
    okb = ok != 0
    pa = pa.float()
    pb = pb.float()
    s = _sample_valid(draws, okb).long()
    t = pb[s] - pa[s]                                        # [T, 2]
    resid = _norm2(pa[None] + t[:, None] - pb[None])
    inl = okb[None, :] & (resid < tol)
    hyp = _first_argmax(inl.sum(dim=1))
    w = inl[hyp].float()
    t_ref = ((pb - pa) * w[:, None]).sum(dim=0) / torch.clamp_min(w.sum(), 1.0)
    inl2, n2, rms = _finish(_norm2(pa + t_ref - pb), okb, tol)
    return TranslationEstimate(t_ref, inl2, n2, rms)


def estimate_similarity(pa, pb, ok, draws=None, tol: float = 2.0, *,
                        iters: int = 256, seed: int = 0
                        ) -> SimilarityEstimate:
    """RANSAC similarity (scale, rotation, translation) in complex64:
    points ``c = x + iy``, model ``c_b = z c_a + t``, ``z = scale e^{iθ}``.
    Two-point hypotheses from ``draws`` [iters, 2]; weighted complex least
    squares refines the winner."""
    if draws is None:
        draws = uniform_draws((iters, 2), seed, device=pa.device)
    okb = ok != 0
    pa = pa.float()
    pb = pb.float()
    a = torch.complex(pa[:, 1], pa[:, 0])
    b = torch.complex(pb[:, 1], pb[:, 0])
    s = _sample_valid(draws, okb).long()
    a1, a2 = a[s[:, 0]], a[s[:, 1]]
    b1, b2 = b[s[:, 0]], b[s[:, 1]]
    den = a2 - a1
    good = den.abs() > 1e-6
    z = (b2 - b1) / torch.where(good, den, torch.ones_like(den))
    t = b1 - z * a1
    resid = (z[:, None] * a[None, :] + t[:, None] - b[None, :]).abs()
    inl = okb[None, :] & (resid < tol) & good[:, None]
    hyp = _first_argmax(inl.sum(dim=1))
    w = inl[hyp].float()
    sw = torch.clamp_min(w.sum(), 1e-6)
    am = (w * a).sum() / sw
    bm = (w * b).sum() / sw
    z2 = ((w * torch.conj(a - am) * (b - bm)).sum()
          / torch.clamp_min((w * (a - am).abs() ** 2).sum(), 1e-9))
    t2 = bm - z2 * am
    inl2, n2, rms = _finish((z2 * a + t2 - b).abs(), okb, tol)
    return SimilarityEstimate(z2.abs(), torch.angle(z2),
                              torch.stack([t2.imag, t2.real]), inl2, n2, rms)


def register_pair(ya, xa, desc_a, valid_a, yb, xb, desc_b, valid_b,
                  draws=None, ratio: float = 0.8, tol: float = 2.0, *,
                  metric: Optional[str] = None, model: str = "translation",
                  iters: int = 128, use_kernels: Optional[bool] = None,
                  seed: int = 0):
    """Match two scenes' feature sets and estimate the transform between
    them.  ``draws`` are RANSAC's uniform numbers (default from ``seed``).
    Returns (PairMatches, estimate)."""
    m = match_pair(desc_a, valid_a, desc_b, valid_b, ratio, metric=metric,
                   use_kernels=use_kernels)
    pa = torch.stack([ya, xa], dim=-1).float()
    ib = m.idx_b.long()
    pb = torch.stack([yb[ib], xb[ib]], dim=-1).float()
    if model == "translation":
        est = estimate_translation(pa, pb, m.ok, draws, tol, iters=iters,
                                   seed=seed)
    elif model == "similarity":
        est = estimate_similarity(pa, pb, m.ok, draws, tol, iters=iters,
                                  seed=seed)
    else:
        raise ValueError(f"unknown model {model!r}")
    return m, est
