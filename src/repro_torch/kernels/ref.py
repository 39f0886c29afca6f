"""Plain PyTorch twins of the four stencil kernels, and the matcher's
oracles.

Each twin computes what its kernel computes, with the kernels' convention:
reflect-pad the image ONCE (by index map, ``jnp.pad`` multi-bounce
semantics), then valid slices.  The production detectors in
``repro_torch.core`` pad per stage instead; the two conventions agree except
in a border band of about the cumulative stencil radius, which DIFET's
interior-ownership rule (halo 24) keeps out of the counts.

Float order is the kernels' own (taps summed left to right, one rounding
per multiply and per add), so on the same device a kernel and its twin give
the same bits.  A wrapper in ``repro_torch.kernels`` runs its twin only for
a tensor on the CPU; ``chip_smoke.py`` holds each kernel against its twin.

The matcher's plain twins live beside its wrappers in ``kernels/matcher.py``;
``match_best2`` and ``match_best2_blocked`` here are its oracles, with the
reference's independent formulation (Hamming by unpacked bits, L2 on the
whole matrix).
"""
from __future__ import annotations

import torch

from repro_torch.core.detectors import FAST_OFFSETS
from repro_torch.core.padding import reflect_pad
from repro_torch.core.pyramid import (
    blur_valid, f32, gaussian_kernel_1d, octave_increments, sobel_valid,
    sqrt_rn,
)


def harris(img: torch.Tensor, *, k: float = 0.04, sigma: float = 1.0,
           shi_tomasi: bool = False) -> torch.Tensor:
    """Sobel/8 -> gradient products -> separable Gaussian window ->
    ``det - k*tr^2`` (or the Shi-Tomasi min eigenvalue)."""
    h, w = img.shape[-2:]
    taps = gaussian_kernel_1d(float(sigma))
    r = (len(taps) - 1) // 2
    x = reflect_pad(img, r + 1)
    gx, gy = sobel_valid(x, h + 2 * r, w + 2 * r)
    ixx = blur_valid(gx * gx, taps, h, w)
    iyy = blur_valid(gy * gy, taps, h, w)
    ixy = blur_valid(gx * gy, taps, h, w)
    if shi_tomasi:
        half_tr = 0.5 * (ixx + iyy)
        d = ixx - iyy
        rad = sqrt_rn(torch.clamp_min(0.25 * (d * d) + ixy * ixy, 0.0))
        return half_tr - rad
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - f32(k) * tr * tr


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian on the image reflect-padded by r = ceil(3 sigma)."""
    h, w = img.shape[-2:]
    taps = gaussian_kernel_1d(float(sigma))
    r = (len(taps) - 1) // 2
    return blur_valid(reflect_pad(img, r), taps, h, w)


def fast_score(img: torch.Tensor, *, threshold: float = 0.15,
               arc: int = 9) -> torch.Tensor:
    """FAST-N: a contiguous arc of >= ``arc`` ring pixels all brighter than
    centre + t (or all darker than centre - t); score
    ``max(sum_brighter(|d| - t), sum_darker(|d| - t))``, 0 off corners."""
    h, w = img.shape[-2:]
    t = f32(threshold)
    x = reflect_pad(img, 3)
    center = x[..., 3:3 + h, 3:3 + w]
    circ = [x[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
            for dy, dx in FAST_OFFSETS]
    hi, lo = center + t, center - t
    brighter = [c > hi for c in circ]
    darker = [c < lo for c in circ]

    def has_arc(flags):
        hit = None
        for start in range(16):
            run = flags[start]
            for j in range(1, arc):
                run = run & flags[(start + j) % 16]
            hit = run if hit is None else hit | run
        return hit

    is_corner = has_arc(brighter) | has_arc(darker)
    zero = torch.zeros_like(center)
    score_b, score_d = zero, zero
    for c, b, dk in zip(circ, brighter, darker):
        diff = (c - center).abs() - t
        score_b = score_b + torch.where(b, diff, zero)
        score_d = score_d + torch.where(dk, diff, zero)
    return torch.where(is_corner, torch.maximum(score_b, score_d), zero)


def scalespace_taps(scales_per_octave: int, sigma0: float):
    """Taps of the octave's incremental blurs, levels 1..n_scales-1."""
    return [gaussian_kernel_1d(s)
            for s in octave_increments(scales_per_octave, float(sigma0))]


def scalespace_octave(base: torch.Tensor, *, scales_per_octave: int,
                      contrast_threshold: float, sigma0: float = 1.6):
    """One SIFT octave from the base padded once by P = sum(radii) + 1:
    incremental blurs with shrinking margins, DoG = cur - prev, the seed
    level (s = S), and the strict 26-neighbour extremum test written as a
    plain 26-stack.  Returns (resp [..., H, W], seed [..., H, W])."""
    h, w = base.shape[-2:]
    taps_list = scalespace_taps(scales_per_octave, sigma0)
    margin = sum((len(t) - 1) // 2 for t in taps_list) + 1
    prev = reflect_pad(base, margin)
    dogs, seed = [], None                        # dogs: (slab, margin)
    for s, taps in enumerate(taps_list, start=1):
        r = (len(taps) - 1) // 2
        m = margin - r
        cur = blur_valid(prev, taps, h + 2 * m, w + 2 * m)
        dogs.append((cur - prev[..., r:r + h + 2 * m, r:r + w + 2 * m], m))
        if s == scales_per_octave:
            seed = cur[..., m:m + h, m:m + w]
        prev, margin = cur, m
    # align every DoG slab on the margin-1 extent, stack over scale
    d = torch.stack([dg[..., m - 1:m - 1 + h + 2, m - 1:m - 1 + w + 2]
                     for dg, m in dogs], dim=-3)
    s_dim = d.shape[-3]
    mid = d[..., 1:s_dim - 1, 1:h + 1, 1:w + 1]
    neigh = torch.stack([
        d[..., 1 + ds:1 + ds + s_dim - 2, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
        if (ds, dy, dx) != (0, 0, 0)])
    is_ext = (mid > neigh.amax(dim=0)) | (mid < neigh.amin(dim=0))
    a = mid.abs()
    resp = torch.where(is_ext & (a > f32(contrast_threshold)), a,
                       torch.zeros_like(a)).amax(dim=-3)
    return resp, seed.contiguous()


# --- matcher oracles ---------------------------------------------------------
BIG_HAMMING = 1 << 30


def _unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 words [N, W] -> bool [N, W*32], little-endian within each word
    (an arithmetic shift of a negative word still leaves bit j in place)."""
    shifts = torch.arange(32, device=x.device, dtype=torch.int32)
    bits = (x[..., None] >> shifts) & 1
    return bits.reshape(x.shape[0], x.shape[1] * 32).bool()


def first_argmin(d: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """The smallest column index holding each row's minimum ``best``
    (``jnp.argmin``'s first occurrence), as int32."""
    cols = torch.arange(d.shape[1], device=d.device)
    at = torch.where(d == best[:, None], cols, d.shape[1])
    return at.amin(dim=1).clamp_max(max(d.shape[1] - 1, 0)).to(torch.int32)


def best2_rows(d: torch.Tensor, big):
    """(best, second, argbest) of each row of a distance block [Q, C]:
    min, first-occurrence argmin, and the min with the argbest column set
    to ``big`` (a tied minimum makes second == best)."""
    best = d.amin(dim=1)
    arg = first_argmin(d, best)
    cols = torch.arange(d.shape[1], device=d.device)
    second = torch.where(cols[None, :] == arg[:, None],
                         torch.full_like(d, big), d).amin(dim=1)
    return best, second, arg


def match_best2(q: torch.Tensor, db: torch.Tensor, db_valid: torch.Tensor, *,
                metric: str):
    """Oracle of the matcher: the full [Q, K] distance matrix.  Hamming by
    counting disagreeing unpacked bits (not the kernel's packed popcount),
    L2 by the norm expansion on the un-chunked matrix.  best/second by min
    and re-min; ties go to the smallest database index.  Hamming distances
    are exact ints, so equality with the kernel is bitwise."""
    if metric == "hamming":
        d = (_unpack_bits(q)[:, None, :] != _unpack_bits(db)[None, :, :]) \
            .sum(dim=-1, dtype=torch.int32)
        big = BIG_HAMMING
    elif metric == "l2":
        q, db = q.float(), db.float()
        qn = (q * q).sum(dim=-1)
        dn = (db * db).sum(dim=-1)
        d = qn[:, None] + dn[None, :] - 2.0 * (q @ db.T)
        big = float("inf")
    else:
        raise ValueError(f"unknown metric {metric!r}")
    if db.shape[0] == 0:
        n = q.shape[0]
        full = torch.full((n,), big, dtype=d.dtype, device=q.device)
        return full, full.clone(), torch.zeros(n, dtype=torch.int32,
                                               device=q.device)
    d = torch.where(db_valid[None, :] != 0, d, torch.full_like(d, big))
    return best2_rows(d, big)


def match_best2_blocked(q: torch.Tensor, db: torch.Tensor,
                        db_valid: torch.Tensor, *, metric: str,
                        block: int = 65536):
    """``match_best2`` over database blocks with a strictly-less merge in
    database order, so parity checks against the streamed paths scale to
    millions of rows without the whole [Q, K] matrix.  Equal to
    ``match_best2`` exactly."""
    big = BIG_HAMMING if metric == "hamming" else float("inf")
    dt = torch.int32 if metric == "hamming" else torch.float32
    nq = q.shape[0]
    best = torch.full((nq,), big, dtype=dt, device=q.device)
    second = best.clone()
    bidx = torch.zeros(nq, dtype=torch.int32, device=q.device)
    for start in range(0, db.shape[0], block):
        cb, cs, ci = match_best2(q, db[start:start + block],
                                 db_valid[start:start + block], metric=metric)
        take = cb < best
        second = torch.where(take, torch.minimum(best, cs),
                             torch.minimum(second, cb))
        bidx = torch.where(take, ci + start, bidx)
        best = torch.where(take, cb, best)
    return best, second, bidx
