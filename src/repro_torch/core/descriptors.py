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
* The fixed tables (Gaussian windows, the BRIEF pattern) are copied to a
  device once and kept (`_device_constant`), so a call makes no host copy
  and can be captured in a CUDA graph (`serve/buckets.py::ServeGraph`).
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


@functools.lru_cache(maxsize=None)
def _device_constant(make, args, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """``make(*args)`` (a numpy table) on ``device`` as ``dtype``, built
    once per key and shared by every call; callers never write to it."""
    return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


def _window_table(size: int, sigma: float) -> np.ndarray:
    c = (size - 1) / 2.0
    y = np.arange(size) - c
    g = np.exp(-0.5 * (y / sigma) ** 2)
    return np.outer(g, g).astype(np.float32)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    return _device_constant(_window_table, (size, sigma), torch.device(device),
                            torch.float32)


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
    pairs = _device_constant(brief_pairs, (n_bits, patch), img.device,
                             torch.int64)
    half = patch // 2
    i1 = ((pairs[:, 0] + half) * patch + pairs[:, 1] + half)[None]
    i2 = ((pairs[:, 2] + half) * patch + pairs[:, 3] + half)[None]
    return pack_bits(_sample_pairs(flat, i1, i2)).reshape(n, k, -1)


def _moment_sums(prod: torch.Tensor) -> torch.Tensor:
    """The sums over the last two dims of ``prod`` [..., 31, 31] in the
    order XLA compiles the reference's moments on the CPU (the fused patch
    gather, products and ``sum(axis=(-2, -1))``): row by row, each row's
    columns 0-23 in 4-wide vectors, two accumulators taking alternate
    vectors (A: columns 0-3, 8-11, 16-19, its lane 0 starting from the sum
    so far; B: 4-7, 12-15, 20-23), added lane-wise and folded as
    (l0 + l2) + (l1 + l3), then columns 24-30 one by one.  A moment near 0
    decides ORB's angle bin (a patch symmetric about its column axis sits
    on the bin edge at +-pi/2), so the order decides words."""
    assert prod.shape[-2:] == (31, 31), prod.shape
    c = prod[..., :24].unflatten(-1, (6, 4))           # [..., row, vec, lane]
    a = (c[..., 0, :] + c[..., 2, :]) + c[..., 4, :]   # lanes 1-3 of A
    b = (c[..., 1, :] + c[..., 3, :]) + c[..., 5, :]
    v2 = b[..., 2] + a[..., 2]
    v13 = (b[..., 1] + a[..., 1]) + (b[..., 3] + a[..., 3])
    acc = torch.zeros(prod.shape[:-2], dtype=prod.dtype, device=prod.device)
    for i in range(31):
        a0 = ((acc + c[..., i, 0, 0]) + c[..., i, 2, 0]) + c[..., i, 4, 0]
        acc = ((b[..., i, 0] + a0) + v2[..., i]) + v13[..., i]
        for j in range(24, 31):
            acc = acc + prod[..., i, j]
    return acc


def _rn(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of float32 ``x``, correctly rounded to float32 (computed in
    float64): as XLA's CPU sin and cos are at ORB's 31 bin angles, where
    torch's float32 sin and cos are an ulp off on several."""
    return fn(x.double()).float()


_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
           1.5707962513e+00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
           7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)
_PI_O_2, _PI, _PI_LO = 1.5707963705e+00, 3.1415927410e+00, -8.7422776573e-08


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's single-precision atan of float32 x >= 0, op for op (Python
    constants: a float32 tensor op rounds them to float32, as the C source's
    float literals are)."""
    ix = x.view(torch.int32)
    t = torch.where(ix < 0x3f300000, (2.0 * x - 1.0) / (2.0 + x),
                    torch.where(ix < 0x3f980000, (x - 1.0) / (x + 1.0),
                                torch.where(ix < 0x401c0000,
                                            (x - 1.5) / (1.0 + 1.5 * x),
                                            -1.0 / x)))
    t = torch.where(ix < 0x3ee00000, x, t)
    z = t * t
    w = z * z
    a = _AT
    s1 = z * (a[0] + w * (a[2] + w * (a[4] + w * (a[6] + w * (a[8]
                                                          + w * a[10])))))
    s2 = w * (a[1] + w * (a[3] + w * (a[5] + w * (a[7] + w * a[9]))))

    def pick(table):
        return torch.where(ix < 0x3f980000, torch.where(
            ix < 0x3f300000, table[0], table[1]), torch.where(
            ix < 0x401c0000, table[2], table[3]))
    r = torch.where(ix < 0x3ee00000, t - t * (s1 + s2),
                    pick(_ATANHI) - ((t * (s1 + s2) - pick(_ATANLO)) - t))
    r = torch.where(ix < 0x31000000, x, r)
    big = torch.full_like(x, _ATANHI[3]) + _ATANLO[3]
    return torch.where(ix >= 0x4c000000, big, r)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 of finite float32 tensors as fdlibm's ``atan2f`` (glibc's, the
    one XLA's CPU code calls for the reference's ``jnp.arctan2``), op for
    op: its results lie up to an ulp from the correctly rounded ones, and
    ORB's angle bins turn on that ulp at +-pi/2."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7fffffff, hy & 0x7fffffff
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    z = _atanf(torch.abs(y / x))
    r = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, _PI - (z - _PI_LO), (z - _PI_LO) - _PI)))
    r = torch.where(ix == 0, torch.where(hy < 0, -_PI_O_2, _PI_O_2), r)
    r = torch.where(iy == 0, torch.where(m <= 1, y, torch.where(
        m == 2, _PI, -_PI)), r)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, r)


def orb_orientation(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation (Rublee et al. 2011): theta [M].
    The moments are summed in XLA's order (`_moment_sums`) and the angle
    taken as the reference's libm takes it (`atan2f`)."""
    p = patches.shape[-1]
    c = (p - 1) / 2.0
    ys = torch.arange(p, device=patches.device, dtype=torch.float32) - c
    m10, m01 = _moment_sums(torch.stack([patches * ys[None, None, :],
                                         patches * ys[None, :, None]]))
    return atan2f(m01, m10)


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
    cos, sin = _rn(torch.cos, theta_q), _rn(torch.sin, theta_q)
    pairs = _device_constant(brief_pairs, (n_bits, patch), img.device,
                             torch.float32)

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
