"""Corner / interest-point detectors: Harris, Shi-Tomasi, FAST, plus the
SIFT DoG-extrema and SURF fast-Hessian detection maps.

Port of ``repro/core/detectors.py``.  Each detector returns a dense
per-pixel response map ``[..., H, W]``; NMS + capacity-K selection
(``repro_torch.core.nms``) turn maps into keypoints.  ``use_kernels=True``
routes Harris, Shi-Tomasi, FAST and the SIFT blurs/octaves through the CUDA
kernels (``repro_torch.kernels.ops``), mirroring the reference's
``use_pallas``; the plain tensor code here is the production path without
kernels, which pads per stage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.padding import reflect_pad
from repro_torch.core.pyramid import (
    blur_separable, blur_separable_seed, box_sum, dog_pyramid, downsample2,
    f32, fused_octave_response, gaussian_pyramid, integral_image,
    sobel_gradients, sqrt_rn,
)


# ---------------------------------------------------------------------------
# structure tensor: Harris & Shi-Tomasi
# ---------------------------------------------------------------------------
def structure_tensor(img: torch.Tensor, sigma: float = 1.0):
    gx, gy = sobel_gradients(img)
    ixx = blur_separable(gx * gx, sigma)
    iyy = blur_separable(gy * gy, sigma)
    ixy = blur_separable(gx * gy, sigma)
    return ixx, iyy, ixy


def harris_response(img: torch.Tensor, k: float = 0.04, sigma: float = 1.0,
                    use_kernels: bool = False) -> torch.Tensor:
    """R = det(M) - k * trace(M)^2  (paper's Harris mapper, steps 2-3)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.harris(img, k=k, sigma=sigma, shi_tomasi=False)
    ixx, iyy, ixy = structure_tensor(img, sigma)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - f32(k) * tr * tr


def shi_tomasi_response(img: torch.Tensor, sigma: float = 1.0,
                        use_kernels: bool = False) -> torch.Tensor:
    """min-eigenvalue response: lambda_min of the structure tensor."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.harris(img, k=0.0, sigma=sigma, shi_tomasi=True)
    ixx, iyy, ixy = structure_tensor(img, sigma)
    half_tr = 0.5 * (ixx + iyy)
    d = ixx - iyy
    rad = sqrt_rn(torch.clamp_min(0.25 * (d * d) + ixy * ixy, 0.0))
    return half_tr - rad


# ---------------------------------------------------------------------------
# FAST segment test
# ---------------------------------------------------------------------------
# Bresenham circle of radius 3: 16 offsets in order.
FAST_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], np.int32)   # (dy, dx)


def _circle_values(img: torch.Tensor) -> torch.Tensor:
    """Stack the 16 circle-neighbour images: [..., 16, H, W]."""
    h, w = img.shape[-2:]
    p = reflect_pad(img, 3)
    return torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in FAST_OFFSETS], dim=-3)


def _arc_max_run(flags: torch.Tensor) -> torch.Tensor:
    """flags [..., 16, H, W] bool -> max circular run length [..., H, W].

    Branch-free: duplicate the ring; a length-``n`` window is all-true iff
    its windowed sum (a difference of cumulative sums) equals n."""
    f = torch.cat([flags, flags], dim=-3).to(torch.int32)
    c = torch.cumsum(f, dim=-3, dtype=torch.int32)             # [..., 32, H, W]
    c = torch.cat([torch.zeros_like(c[..., :1, :, :]), c], dim=-3)
    best = torch.zeros(flags.shape[:-3] + flags.shape[-2:], dtype=torch.int32,
                       device=flags.device)
    for n in range(1, 17):
        run = (c[..., n:, :, :] - c[..., :-n, :, :]) == n    # any n-window
        best = torch.maximum(best, n * run.any(dim=-3).to(torch.int32))
    return best


def fast_score(img: torch.Tensor, threshold: float = 0.15, arc: int = 9,
               use_kernels: bool = False) -> torch.Tensor:
    """FAST-N score map: 0 where not a corner, else sum |I_p - I_center| - t
    over the arc pixels (OpenCV-style score)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.fast_score(img, threshold=threshold, arc=arc)
    t = f32(threshold)
    circ = _circle_values(img)                              # [..., 16, H, W]
    center = img[..., None, :, :]
    brighter = circ > center + t
    darker = circ < center - t
    is_corner = (_arc_max_run(brighter) >= arc) | (_arc_max_run(darker) >= arc)
    diff = (circ - center).abs() - t
    # the arc sums run in ring order, one add at a time: a reduction over
    # the ring dim may group them differently on the card, and an ulp
    # there reorders equal-looking scores in the top-K
    zero = torch.zeros_like(img)
    score_b, score_d = zero, zero
    for i in range(16):
        d = diff[..., i, :, :]
        score_b = score_b + torch.where(brighter[..., i, :, :], d, zero)
        score_d = score_d + torch.where(darker[..., i, :, :], d, zero)
    return torch.where(is_corner, torch.maximum(score_b, score_d), zero)


# ---------------------------------------------------------------------------
# SIFT detection: DoG scale-space extrema
# ---------------------------------------------------------------------------
def sift_dog_response(img: torch.Tensor, n_octaves: int = 4,
                      scales_per_octave: int = 3,
                      contrast_threshold: float = 0.04,
                      use_kernels: bool = False):
    """Per-octave extrema responses, octave 0 first (full resolution);
    response = |DoG| where the pixel is a 3x3x3 scale-space extremum above
    the contrast threshold, else 0.  Each octave seeds the next through
    ``downsample2`` of its level with total sigma ``2*sigma0``."""
    base = blur_separable(img, 1.6, use_kernels)
    responses = []
    for _ in range(n_octaves):
        resp, seed = fused_octave_response(
            base, scales_per_octave, contrast_threshold,
            use_kernels=use_kernels)
        responses.append(resp)
        base = downsample2(seed)
    return responses


def sift_dog_response_levelwise(img: torch.Tensor, n_octaves: int = 4,
                                scales_per_octave: int = 3,
                                contrast_threshold: float = 0.04,
                                use_kernels: bool = False):
    """The seed's level-by-level SIFT response (`gaussian_pyramid` with
    `blur_separable_seed` -> `dog_pyramid` -> the 26 neighbours stacked):
    the baseline that the fused `sift_dog_response` is held to, bitwise
    (the same operations on the same values).  Not on the engine's path."""
    octs = gaussian_pyramid(img, n_octaves, scales_per_octave,
                            use_kernels=use_kernels,
                            blur_fn=blur_separable_seed)
    responses = []
    for d in dog_pyramid(octs):                            # [..., S, H, W]
        s = d.shape[-3]
        mid = d[..., 1:s - 1, :, :]
        h, w = mid.shape[-2:]
        p = reflect_pad(d, 1)
        neigh = torch.stack([
            p[..., 1 + ds:1 + ds + s - 2, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            if (ds, dy, dx) != (0, 0, 0)])
        is_ext = (mid > neigh.amax(dim=0)) | (mid < neigh.amin(dim=0))
        a = mid.abs()
        resp = torch.where(is_ext & (a > f32(contrast_threshold)), a,
                           torch.zeros_like(a))
        responses.append(resp.amax(dim=-3))                # over scales
    return responses


# ---------------------------------------------------------------------------
# SURF detection: fast-Hessian (box-filter approximation, 9x9 lobe)
# ---------------------------------------------------------------------------
def surf_hessian_response(img: torch.Tensor,
                          use_kernels: bool = False) -> torch.Tensor:
    """det(H_approx) with 9x9 box filters (SURF's first scale), normalized.

    Dxx: lobes 5(h) x 3(w); weights (1, -2, 1); Dyy transposed; Dxy four
    3x3 corner boxes with weights (+1, -1, -1, +1).  Plain tensor code on
    both routes: the reference has no kernel for it either."""
    del use_kernels
    ii = integral_image(img)
    dxx = (box_sum(ii, -2, -4, 5, 3) - 2 * box_sum(ii, -2, -1, 5, 3)
           + box_sum(ii, -2, 2, 5, 3))
    dyy = (box_sum(ii, -4, -2, 3, 5) - 2 * box_sum(ii, -1, -2, 3, 5)
           + box_sum(ii, 2, -2, 3, 5))
    dxy = (box_sum(ii, -4, 1, 3, 3) + box_sum(ii, 1, -4, 3, 3)
           - box_sum(ii, -4, -4, 3, 3) - box_sum(ii, 1, 1, 3, 3))
    norm = f32(1.0 / 81.0)
    dxx, dyy, dxy = dxx * norm, dyy * norm, dxy * norm
    q = 0.9 * dxy
    return dxx * dyy - q * q
