"""Feature descriptors: SIFT (128-d), SURF (64-d), BRIEF (256-bit),
ORB (steered BRIEF, 256-bit).

Port of ``repro/core/descriptors.py`` over a batch of tiles: ``img``
``[N, H, W]`` with keypoints ``ys, xs`` ``[N, K]`` give ``[N, K, D]``.

* Histograms are dense one-hot sums, not scatter-adds: float atomics would
  change the bits from run to run on the card, and a sum over a fixed axis
  does not.  No matrix product is used, so TF32 never applies.
* Binary descriptors are packed 32 bits to a word, little-endian within the
  word (the reference's ``pack_bits`` layout), and held as int32 because
  torch has no shifts for uint32; ``np.asarray(ref_words).view(np.int32)``
  compares them with the reference.
* With ``use_kernels`` the blurs run through the CUDA blur kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.pyramid import blur_separable, sobel_gradients


def extract_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    size: int) -> torch.Tensor:
    """img [N,H,W]; ys,xs [N,K] (patch centres) -> patches [N,K,size,size].
    Start indices clip so patches near borders stay in-bounds."""
    n, h, w = img.shape
    half = size // 2
    y0 = (ys.long() - half).clamp(0, h - size)                # [N,K]
    x0 = (xs.long() - half).clamp(0, w - size)
    d = torch.arange(size, device=img.device)
    rows = y0[..., None] + d                                  # [N,K,size]
    cols = x0[..., None] + d
    flat = rows[..., :, None] * w + cols[..., None, :]        # [N,K,s,s]
    k = ys.shape[1]
    out = torch.gather(img.reshape(n, h * w), 1, flat.reshape(n, -1))
    return out.reshape(n, k, size, size)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    c = (size - 1) / 2.0
    y = np.arange(size) - c
    g = np.exp(-0.5 * (y / sigma) ** 2)
    return torch.from_numpy(np.outer(g, g).astype(np.float32)).to(device)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` along a new last dim of size ``n``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def _l2_normalize(desc: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt((desc * desc).sum(dim=-1, keepdim=True))
    return desc / torch.clamp_min(norm, 1e-6)


# ---------------------------------------------------------------------------
# SIFT descriptor
# ---------------------------------------------------------------------------
def sift_descriptors(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     use_kernels: bool = False, n_bins: int = 8,
                     n_cells: int = 4, patch: int = 16) -> torch.Tensor:
    """128-d SIFT descriptors at keypoints: [N,K] -> [N,K,128]
    (L2-normalized, 0.2-clipped).  Orientation from a 36-bin gradient
    histogram; spatial binning is hard assignment."""
    del use_kernels                       # no blur in SIFT's descriptor
    n, k = ys.shape
    g = patch + 2
    patches = extract_patches(img, ys, xs, g).reshape(n * k, g, g)
    gx, gy = sobel_gradients(patches)
    gx = gx[:, 1:-1, 1:-1]
    gy = gy[:, 1:-1, 1:-1]                                    # [M,p,p]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)                                 # [-pi, pi]

    # --- dominant orientation: 36-bin weighted histogram -------------------
    w36 = _gaussian_window(patch, patch / 3.0, img.device)
    bins36 = torch.floor((ang + np.pi) / (2 * np.pi) * 36).long() % 36
    hist36 = (_one_hot(bins36.reshape(n * k, -1), 36)
              * (mag * w36).reshape(n * k, -1, 1)).sum(dim=1)
    theta = (torch.argmax(hist36, dim=-1).to(torch.float32) + 0.5) \
        / 36.0 * 2 * np.pi - np.pi                            # [M]

    # --- rotate gradient field by -theta, bin into 4x4x8 -------------------
    rel_ang = (ang - theta[:, None, None] + 3 * np.pi) % (2 * np.pi)
    obins = torch.floor(rel_ang / (2 * np.pi) * n_bins).long() % n_bins
    wgt = mag * _gaussian_window(patch, patch / 2.0, img.device)
    cell = patch // n_cells

    def by_cell(a):   # [M, p, p] -> [M, n_cells*n_cells, cell*cell]
        a = a.reshape(-1, n_cells, cell, n_cells, cell).permute(0, 1, 3, 2, 4)
        return a.reshape(a.shape[0], n_cells * n_cells, cell * cell)

    desc = (_one_hot(by_cell(obins), n_bins)                  # [M,16,16,8]
            * by_cell(wgt)[..., None]).sum(dim=2)             # [M,16,8]
    desc = _l2_normalize(desc.reshape(n * k, n_cells * n_cells * n_bins))
    desc = _l2_normalize(torch.clamp_max(desc, 0.2))
    return desc.reshape(n, k, -1)


# ---------------------------------------------------------------------------
# SURF descriptor
# ---------------------------------------------------------------------------
def surf_descriptors(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     use_kernels: bool = False,
                     patch: int = 20) -> torch.Tensor:
    """64-d SURF: 4x4 subregions x (sum dx, sum |dx|, sum dy, sum |dy|) of
    Haar responses (central differences on the sigma-1 smoothed patch)."""
    n, k = ys.shape
    g = patch + 2
    patches = extract_patches(img, ys, xs, g).reshape(n * k, g, g)
    sm = blur_separable(patches, 1.0, use_kernels)
    dx = sm[:, 1:-1, 2:] - sm[:, 1:-1, :-2]
    dy = sm[:, 2:, 1:-1] - sm[:, :-2, 1:-1]                   # [M,p,p]
    w = _gaussian_window(patch, 3.3, img.device)
    dx, dy = dx * w, dy * w
    sub = patch // 4
    dxs = dx.reshape(-1, 4, sub, 4, sub)
    dys = dy.reshape(-1, 4, sub, 4, sub)
    feats = torch.stack([
        dxs.sum(dim=(2, 4)), dxs.abs().sum(dim=(2, 4)),
        dys.sum(dim=(2, 4)), dys.abs().sum(dim=(2, 4)),
    ], dim=-1)                                                # [M,4,4,4]
    return _l2_normalize(feats.reshape(n * k, 64)).reshape(n, k, 64)


# ---------------------------------------------------------------------------
# BRIEF / ORB descriptors (binary)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4)
def brief_pairs(n_bits: int = 256, patch: int = 31, seed: int = 7) -> np.ndarray:
    """The fixed BRIEF sampling pattern: isotropic Gaussian, sigma=patch/5
    (Calonder et al. 2010, G I).  Returns int32 [n_bits, 4] = (y1,x1,y2,x2)."""
    rng = np.random.RandomState(seed)
    sigma = patch / 5.0
    pts = np.clip(rng.randn(n_bits, 4) * sigma, -(patch // 2), patch // 2)
    return np.round(pts).astype(np.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 [..., n//32]: bit j of word i is bit 32*i + j
    (the reference's uint32 layout, as a two's-complement int32)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32).to(torch.int64)
    weights = torch.pow(2, torch.arange(32, device=bits.device,
                                        dtype=torch.int64))
    words = (b * weights).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _sample_pairs(flat: torch.Tensor, i1: torch.Tensor,
                  i2: torch.Tensor) -> torch.Tensor:
    """flat [M, P] patch pixels; i1, i2 [M or 1, n] flat indices -> bits."""
    m = flat.shape[0]
    v1 = torch.gather(flat, 1, i1.expand(m, -1))
    v2 = torch.gather(flat, 1, i2.expand(m, -1))
    return v1 < v2


def brief_descriptors(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                      use_kernels: bool = False, n_bits: int = 256,
                      patch: int = 31) -> torch.Tensor:
    """BRIEF: smoothed-intensity pair tests -> packed int32 [N,K,n_bits/32]."""
    n, k = ys.shape
    sm = blur_separable(img, 2.0, use_kernels)
    flat = extract_patches(sm, ys, xs, patch).reshape(n * k, patch * patch)
    pairs = torch.from_numpy(brief_pairs(n_bits, patch)).to(img.device).long()
    half = patch // 2
    i1 = ((pairs[:, 0] + half) * patch + pairs[:, 1] + half)[None]
    i2 = ((pairs[:, 2] + half) * patch + pairs[:, 3] + half)[None]
    return pack_bits(_sample_pairs(flat, i1, i2)).reshape(n, k, -1)


def orb_orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (Rublee et al. 2011): theta [M]."""
    p = patches.shape[-1]
    c = (p - 1) / 2.0
    ys = torch.arange(p, device=patches.device, dtype=torch.float32) - c
    m10 = (patches * ys[None, None, :]).sum(dim=(-2, -1))    # x moment
    m01 = (patches * ys[None, :, None]).sum(dim=(-2, -1))    # y moment
    return torch.atan2(m01, m10)


def orb_descriptors(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    use_kernels: bool = False, n_bits: int = 256,
                    patch: int = 31) -> torch.Tensor:
    """ORB = oriented FAST + rotated BRIEF: the pair pattern is rotated by
    the patch orientation (discretized to 2*pi/30 as in the paper)."""
    n, k = ys.shape
    sm = blur_separable(img, 2.0, use_kernels)
    big = patch + 14                                        # rotation margin
    patches = extract_patches(sm, ys, xs, big).reshape(n * k, big, big)
    theta = orb_orientation(patches[:, 7:7 + patch, 7:7 + patch])   # [M]
    step = 2 * np.pi / 30.0
    theta_q = torch.round(theta / step) * step
    cos, sin = torch.cos(theta_q), torch.sin(theta_q)
    pairs = torch.from_numpy(brief_pairs(n_bits, patch)).to(
        img.device).to(torch.float32)

    # rotate both endpoints: (y,x) -> (x sin + y cos, x cos - y sin)
    def rot(y, x):
        ry = torch.round(x[None, :] * sin[:, None] + y[None, :] * cos[:, None])
        rx = torch.round(x[None, :] * cos[:, None] - y[None, :] * sin[:, None])
        return ry.long(), rx.long()

    ry1, rx1 = rot(pairs[:, 0], pairs[:, 1])
    ry2, rx2 = rot(pairs[:, 2], pairs[:, 3])
    half = big // 2
    i1 = (ry1 + half) * big + (rx1 + half)
    i2 = (ry2 + half) * big + (rx2 + half)
    bits = _sample_pairs(patches.reshape(n * k, big * big), i1, i2)
    return pack_bits(bits).reshape(n, k, -1)
