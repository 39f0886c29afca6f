"""Non-max suppression + capacity-K keypoint selection (static shapes).

Port of ``repro/core/nms.py`` over a batch of tiles ``[N, H, W]``.  A
detector's dense response map goes through 3x3 NMS, halo/interior
ownership masking, then top-K selection per tile.  Counts are taken on the
dense thresholded map (before truncation), so Table-2 numbers are exact
regardless of capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def nms3x3(resp: torch.Tensor) -> torch.Tensor:
    """Keep values that are the strict max of their 3x3 neighbourhood.

    Windows are padded with -inf (the reference's ``reduce_window`` "SAME"
    padding by the init value).  Plateaus are tie-broken toward the
    smallest row-major flat index, so a plateau emits at most one keypoint
    per 3x3 window."""
    h, w = resp.shape[-2:]
    x = resp.reshape(-1, 1, h, w)
    mx = F.max_pool2d(x, 3, stride=1, padding=1)
    # flat indices stay exact in float32 (h*w < 2**24); +inf pads the min
    idx = torch.arange(h * w, device=resp.device,
                       dtype=torch.float32).reshape(1, 1, h, w)
    at_max = x >= mx
    cand = torch.where(at_max, idx, torch.full_like(x, float("inf")))
    min_idx = -F.max_pool2d(-cand, 3, stride=1, padding=1)
    keep = at_max & (idx == min_idx)
    return torch.where(keep, x, torch.zeros_like(x)).reshape(resp.shape)


def interior_mask(shape_hw, halo: int, valid_h: torch.Tensor,
                  valid_w: torch.Tensor) -> torch.Tensor:
    """Ownership mask [N, H, W]: only interior (non-halo) pixels within each
    tile's valid extent (edge tiles are padded) emit features.
    ``valid_h``/``valid_w`` are per-tile ``[N]``."""
    h, w = shape_hw
    ys = torch.arange(h, device=valid_h.device)
    xs = torch.arange(w, device=valid_w.device)
    my = (ys >= halo) & (ys < halo + valid_h[:, None])        # [N, H]
    mx = (xs >= halo) & (xs < halo + valid_w[:, None])        # [N, W]
    return my[:, :, None] & mx[:, None, :]


def count_above(resp: torch.Tensor, threshold: float,
                mask: torch.Tensor) -> torch.Tensor:
    """Exact per-tile feature count on the dense map: int32 [N]."""
    return ((resp > threshold) & mask).sum(dim=(-2, -1), dtype=torch.int32)


def stable_topk(x: torch.Tensor, k: int):
    """Top-k along the last dim, ties toward the smaller index (the order
    of ``lax.top_k``; ``torch.topk`` does not promise it)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_keypoints(resp: torch.Tensor, k: int, threshold: float,
                   mask: torch.Tensor):
    """Select up to K strongest responses per tile.

    Returns (ys [N,K] int32, xs [N,K] int32, scores [N,K], valid [N,K]);
    invalid slots have score 0 and valid=False.  Ties are broken by flat
    index, so the selection is deterministic and partition-invariant."""
    h, w = resp.shape[-2:]
    keep = mask & (resp > threshold)
    flat = torch.where(keep, resp, torch.full_like(resp, float("-inf")))
    scores, idx = stable_topk(flat.reshape(*resp.shape[:-2], h * w), k)
    valid = torch.isfinite(scores)
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    ys = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
    xs = (idx % w).to(torch.int32)
    return ys, xs, scores, valid
