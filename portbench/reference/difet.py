"""The plain reference of DIFET's extraction: seven detectors and
descriptors per tile, then the reduce (total count and global top-K).

Plain PyTorch, written from the published algorithms in the order that
rounds once per operation, so that in float32 it gives the same fields as
any implementation that keeps that order.  It imports nothing but torch and
numpy.  ``dtype`` runs every floating-point step in another precision
(bfloat16 for the control that must come out not correct); float32 is the
configuration's precision.

Fields per algorithm, as the system under test returns them:
``total_count``, ``per_tile_count``, ``top_scores``, ``top_ys``,
``top_xs``, ``top_valid``, ``keypoint_count`` and, for the describing
algorithms, ``top_desc`` (float for SIFT and SURF, packed int32 words for
BRIEF and ORB).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def f32(x: float) -> float:
    """A Python scalar rounded to float32."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# padding, blurs, gradients
# ---------------------------------------------------------------------------
def reflect_indices(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source index of each padded position: even reflection without edge
    repeat, bouncing again where the pad is wider than the axis."""
    if n == 1:
        return torch.zeros(before + 1 + after, dtype=torch.int64,
                           device=device)
    j = torch.arange(-before, n + after, device=device).abs() % (2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return (x.index_select(-2, reflect_indices(h, pad, pad, x.device))
            .index_select(-1, reflect_indices(w, pad, pad, x.device)))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded once to x's precision."""
    return torch.sqrt(x.double()).to(x.dtype)


@functools.lru_cache(maxsize=64)
def gaussian_taps(sigma: float) -> np.ndarray:
    r = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, reflect-padded by its radius: the W pass,
    then the H pass, each tap a multiply and an add, left to right."""
    taps = gaussian_taps(float(sigma))
    n = len(taps)
    h, w = img.shape[-2:]
    x = reflect_pad(img, (n - 1) // 2)
    tmp = float(taps[0]) * x[..., :, 0:w]
    for j in range(1, n):
        tmp = tmp + float(taps[j]) * x[..., :, j:j + w]
    out = float(taps[0]) * tmp[..., 0:h, :]
    for i in range(1, n):
        out = out + float(taps[i]) * tmp[..., i:i + h, :]
    return out


def sobel(img: torch.Tensor):
    """Sobel gradients divided by 8, reflect-padded by 1."""
    h, w = img.shape[-2:]
    x = reflect_pad(img, 1)

    def sl(dy, dx):
        return x[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1)) / 8.0
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1)) / 8.0
    return gx, gy


def blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive scan summed in blocks of 16: sequential inside a block, the
    block totals scanned the same way, then each block's exclusive prefix
    added once."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= 16:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out.movedim(-1, dim)
    nb = -(-n // 16)
    xp = F.pad(x, (0, nb * 16 - n))
    inner = blocked_cumsum(xp.reshape(*x.shape[:-1], nb, 16), -1)
    prefix = blocked_cumsum(inner[..., -1], -1)
    excl = F.pad(prefix[..., :-1], (1, 0))
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], nb * 16)
    return out[..., :n].movedim(-1, dim)


def box_sum(ii: torch.Tensor, y0: int, x0: int, h: int, w: int):
    """Sums of the (h, w) boxes whose top-left corner is (y + y0, x + x0),
    from the summed-area table ``ii`` [..., H+1, W+1], reads clamped."""
    hh, ww = ii.shape[-2] - 1, ii.shape[-1] - 1

    def at(dy, dx):
        ys = (torch.arange(hh, device=ii.device) + dy).clamp(0, hh)
        xs = (torch.arange(ww, device=ii.device) + dx).clamp(0, ww)
        return ii.index_select(-2, ys).index_select(-1, xs)
    return (at(y0 + h, x0 + w) - at(y0, x0 + w)
            - at(y0 + h, x0) + at(y0, x0))


# ---------------------------------------------------------------------------
# response maps
# ---------------------------------------------------------------------------
def structure_tensor(img, sigma=1.0):
    gx, gy = sobel(img)
    return blur(gx * gx, sigma), blur(gy * gy, sigma), blur(gx * gy, sigma)


def harris(img, k):
    ixx, iyy, ixy = structure_tensor(img)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - f32(k) * tr * tr


def shi_tomasi(img):
    ixx, iyy, ixy = structure_tensor(img)
    half_tr = 0.5 * (ixx + iyy)
    d = ixx - iyy
    return half_tr - sqrt_rn(torch.clamp_min(0.25 * (d * d) + ixy * ixy,
                                             0.0))


# Bresenham circle of radius 3, in ring order: (dy, dx)
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
        (-3, -1))


def _longest_run(flags: torch.Tensor) -> torch.Tensor:
    """flags [..., 16, H, W] -> the longest circular run of true [..., H, W]."""
    f = torch.cat([flags, flags], dim=-3).to(torch.int32)
    c = torch.cumsum(f, dim=-3, dtype=torch.int32)
    c = torch.cat([torch.zeros_like(c[..., :1, :, :]), c], dim=-3)
    best = torch.zeros(flags.shape[:-3] + flags.shape[-2:], dtype=torch.int32,
                       device=flags.device)
    for n in range(1, 17):
        run = (c[..., n:, :, :] - c[..., :-n, :, :]) == n
        best = torch.maximum(best, n * run.any(dim=-3).to(torch.int32))
    return best


def fast(img, threshold, arc):
    """FAST-``arc`` score: the larger of the brighter and the darker arc
    sums of |I_p - I_c| - t, where either run reaches ``arc``; else 0."""
    t = f32(threshold)
    h, w = img.shape[-2:]
    p = reflect_pad(img, 3)
    circ = torch.stack([p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dy, dx in RING], dim=-3)
    center = img[..., None, :, :]
    brighter = circ > center + t
    darker = circ < center - t
    corner = (_longest_run(brighter) >= arc) | (_longest_run(darker) >= arc)
    diff = (circ - center).abs() - t
    zero = torch.zeros_like(img)
    sb, sd = zero, zero
    for i in range(16):
        d = diff[..., i, :, :]
        sb = sb + torch.where(brighter[..., i, :, :], d, zero)
        sd = sd + torch.where(darker[..., i, :, :], d, zero)
    return torch.where(corner, torch.maximum(sb, sd), zero)


def octave_increments(spo: int, sigma0: float = 1.6):
    k = 2.0 ** (1.0 / spo)
    incs, prev = [], sigma0
    for s in range(1, spo + 3):
        total = sigma0 * k ** s
        incs.append(float(np.sqrt(max(total ** 2 - prev ** 2, 1e-6))))
        prev = total
    return incs


def _neighbour_extremes(d):
    """(3x3 max, 3x3 min, 8-ring max, 8-ring min) of one DoG level,
    reflect-padded by 1."""
    h, w = d.shape[-2:]
    p = reflect_pad(d, 1)
    c0, c1, c2 = p[..., :, 0:w], p[..., :, 1:w + 1], p[..., :, 2:w + 2]
    mx3 = torch.maximum(torch.maximum(c0, c1), c2)
    mn3 = torch.minimum(torch.minimum(c0, c1), c2)
    mx2, mn2 = torch.maximum(c0, c2), torch.minimum(c0, c2)

    def row(y, a):
        return a[..., y:y + h, :]
    return (torch.maximum(torch.maximum(row(0, mx3), row(1, mx3)),
                          row(2, mx3)),
            torch.minimum(torch.minimum(row(0, mn3), row(1, mn3)),
                          row(2, mn3)),
            torch.maximum(torch.maximum(row(0, mx3), row(2, mx3)),
                          row(1, mx2)),
            torch.minimum(torch.minimum(row(0, mn3), row(2, mn3)),
                          row(1, mn2)))


def sift(img, spo, contrast):
    """Octave 0 of SIFT's detector: |DoG| where a level is a strict 3x3x3
    extremum above the contrast threshold, the largest over the mid
    levels; 0 elsewhere."""
    prev = blur(img, 1.6)
    dogs = []
    for inc in octave_increments(spo):
        cur = blur(prev, inc)
        dogs.append(cur - prev)
        prev = cur
    stats = [_neighbour_extremes(d) for d in dogs]
    resp = None
    for s in range(1, len(dogs) - 1):
        nmax = torch.maximum(torch.maximum(stats[s - 1][0], stats[s + 1][0]),
                             stats[s][2])
        nmin = torch.minimum(torch.minimum(stats[s - 1][1], stats[s + 1][1]),
                             stats[s][3])
        mid = dogs[s]
        a = mid.abs()
        r = torch.where(((mid > nmax) | (mid < nmin)) & (a > f32(contrast)),
                        a, torch.zeros_like(a))
        resp = r if resp is None else torch.maximum(resp, r)
    return resp


def surf(img):
    """det of the 9x9 box-filter Hessian (SURF's first scale), normalised."""
    ii = F.pad(blocked_cumsum(blocked_cumsum(img, -2), -1), (1, 0, 1, 0))
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


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------
def patches_at(img, ys, xs, size):
    """img [N,H,W], centres [N,K] -> [N,K,size,size], starts clipped in."""
    n, h, w = img.shape
    half = size // 2
    y0 = (ys.long() - half).clamp(0, h - size)
    x0 = (xs.long() - half).clamp(0, w - size)
    d = torch.arange(size, device=img.device)
    flat = ((y0[..., None] + d)[..., :, None] * w
            + (x0[..., None] + d)[..., None, :])
    out = torch.gather(img.reshape(n, h * w), 1, flat.reshape(n, -1))
    return out.reshape(n, ys.shape[1], size, size)


@functools.lru_cache(maxsize=None)
def _window(size, sigma, device, dtype):
    c = (size - 1) / 2.0
    g = np.exp(-0.5 * ((np.arange(size) - c) / sigma) ** 2)
    return torch.from_numpy(np.outer(g, g).astype(np.float32)).to(
        device=device, dtype=dtype)


def _one_hot(idx, n, dtype):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _normalize(d):
    return d / torch.clamp_min(torch.sqrt((d * d).sum(dim=-1, keepdim=True)),
                               1e-6)


def sift_desc(img, ys, xs, n_bins=8, n_cells=4, patch=16):
    """128-d SIFT: orientation from a 36-bin weighted gradient histogram,
    then 4x4 cells x 8 bins of the rotated gradients, normalised, clipped
    at 0.2 and normalised again."""
    n, k = ys.shape
    g = patch + 2
    gx, gy = sobel(patches_at(img, ys, xs, g).reshape(n * k, g, g))
    gx, gy = gx[:, 1:-1, 1:-1], gy[:, 1:-1, 1:-1]
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)
    dt = img.dtype
    bins36 = torch.floor((ang + np.pi) / (2 * np.pi) * 36).long() % 36
    hist = (_one_hot(bins36.reshape(n * k, -1), 36, dt)
            * (mag * _window(patch, patch / 3.0, img.device, dt))
            .reshape(n * k, -1, 1)).sum(dim=1)
    theta = ((torch.argmax(hist, dim=-1).to(dt) + 0.5) / 36.0 * 2 * np.pi
             - np.pi)
    rel = (ang - theta[:, None, None] + 3 * np.pi) % (2 * np.pi)
    obins = torch.floor(rel / (2 * np.pi) * n_bins).long() % n_bins
    wgt = mag * _window(patch, patch / 2.0, img.device, dt)
    cell = patch // n_cells

    def by_cell(a):
        a = a.reshape(-1, n_cells, cell, n_cells, cell).permute(0, 1, 3, 2, 4)
        return a.reshape(a.shape[0], n_cells * n_cells, cell * cell)
    d = (_one_hot(by_cell(obins), n_bins, dt)
         * by_cell(wgt)[..., None]).sum(dim=2)
    d = _normalize(d.reshape(n * k, n_cells * n_cells * n_bins))
    return _normalize(torch.clamp_max(d, 0.2)).reshape(n, k, -1)


def surf_desc(img, ys, xs, patch=20):
    """64-d SURF: per 4x4 subregion the sums of dx, |dx|, dy, |dy| of the
    Gaussian-weighted Haar responses of the sigma-1 smoothed patch."""
    n, k = ys.shape
    g = patch + 2
    sm = blur(patches_at(img, ys, xs, g).reshape(n * k, g, g), 1.0)
    dx = sm[:, 1:-1, 2:] - sm[:, 1:-1, :-2]
    dy = sm[:, 2:, 1:-1] - sm[:, :-2, 1:-1]
    w = _window(patch, 3.3, img.device, img.dtype)
    dx, dy = dx * w, dy * w
    sub = patch // 4
    dxs, dys = dx.reshape(-1, 4, sub, 4, sub), dy.reshape(-1, 4, sub, 4, sub)
    feats = torch.stack([dxs.sum(dim=(2, 4)), dxs.abs().sum(dim=(2, 4)),
                         dys.sum(dim=(2, 4)), dys.abs().sum(dim=(2, 4))],
                        dim=-1)
    return _normalize(feats.reshape(n * k, 64)).reshape(n, k, 64)


@functools.lru_cache(maxsize=4)
def brief_pattern(n_bits=256, patch=31, seed=7) -> np.ndarray:
    """BRIEF's fixed pair pattern (Calonder et al. 2010, G I): isotropic
    Gaussian, sigma = patch / 5, from a fixed seed: [n_bits, 4] (y1, x1,
    y2, x2)."""
    pts = np.random.RandomState(seed).randn(n_bits, 4) * (patch / 5.0)
    return np.round(np.clip(pts, -(patch // 2), patch // 2)).astype(np.int32)


def pack_bits(bits):
    """bool [..., n] -> int32 words [..., n // 32], bit j of word i being
    bit 32 i + j (little-endian within a word, two's complement)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32).to(
        torch.int64)
    words = (b * torch.pow(2, torch.arange(32, device=bits.device,
                                           dtype=torch.int64))).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _pair_bits(flat, i1, i2):
    m = flat.shape[0]
    return (torch.gather(flat, 1, i1.expand(m, -1))
            < torch.gather(flat, 1, i2.expand(m, -1)))


def brief_desc(img, ys, xs, n_bits=256, patch=31):
    n, k = ys.shape
    sm = blur(img, 2.0)
    flat = patches_at(sm, ys, xs, patch).reshape(n * k, patch * patch)
    pairs = torch.from_numpy(brief_pattern(n_bits, patch)).to(
        device=img.device, dtype=torch.int64)
    half = patch // 2
    i1 = ((pairs[:, 0] + half) * patch + pairs[:, 1] + half)[None]
    i2 = ((pairs[:, 2] + half) * patch + pairs[:, 3] + half)[None]
    return pack_bits(_pair_bits(flat, i1, i2)).reshape(n, k, -1)


def moment_sums(prod):
    """Sums over the last two dims of [..., 31, 31], grouped as a 4-wide
    two-accumulator vector loop over columns 0-23 of each row, then
    columns 24-30 one by one (the order an x86 compiler gives the plain
    double loop): a moment near 0 decides ORB's angle bin."""
    c = prod[..., :24].unflatten(-1, (6, 4))
    a = (c[..., 0, :] + c[..., 2, :]) + c[..., 4, :]
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


_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
           1.5707962513e+00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
           7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)
_PI_O_2, _PI, _PI_LO = 1.5707963705e+00, 3.1415927410e+00, -8.7422776573e-08


def _atanf(x):
    """fdlibm's single-precision atan of float32 x >= 0, step for step."""
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


def atan2f(y, x):
    """fdlibm's single-precision atan2 (glibc's atan2f), step for step; in
    another precision, torch's atan2."""
    if x.dtype != torch.float32:
        return torch.atan2(y, x)
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


def orb_desc(img, ys, xs, n_bits=256, patch=31):
    """ORB (Rublee et al. 2011): BRIEF's pairs rotated by the patch's
    intensity-centroid angle, quantised to 2 pi / 30."""
    n, k = ys.shape
    dt = img.dtype
    sm = blur(img, 2.0)
    big = patch + 14
    patches = patches_at(sm, ys, xs, big).reshape(n * k, big, big)
    core = patches[:, 7:7 + patch, 7:7 + patch]
    r = torch.arange(patch, device=img.device, dtype=dt) - (patch - 1) / 2.0
    m10, m01 = moment_sums(torch.stack([core * r[None, None, :],
                                        core * r[None, :, None]]))
    step = 2 * np.pi / 30.0
    theta = torch.round(atan2f(m01, m10) / step) * step
    cos = torch.cos(theta.double()).to(dt)
    sin = torch.sin(theta.double()).to(dt)
    pairs = torch.from_numpy(brief_pattern(n_bits, patch)).to(
        device=img.device, dtype=dt)

    def rot(y, x):
        ry = torch.round(x[None, :] * sin[:, None] + y[None, :] * cos[:, None])
        rx = torch.round(x[None, :] * cos[:, None] - y[None, :] * sin[:, None])
        return ry.long(), rx.long()
    ry1, rx1 = rot(pairs[:, 0], pairs[:, 1])
    ry2, rx2 = rot(pairs[:, 2], pairs[:, 3])
    half = big // 2
    bits = _pair_bits(patches.reshape(n * k, big * big),
                      (ry1 + half) * big + (rx1 + half),
                      (ry2 + half) * big + (rx2 + half))
    return pack_bits(bits).reshape(n, k, -1)


# ---------------------------------------------------------------------------
# selection per tile, and the reduce
# ---------------------------------------------------------------------------
def nms3x3(resp):
    """Keep the strict maximum of each 3x3 window (-inf outside the map);
    a plateau keeps its smallest row-major index."""
    h, w = resp.shape[-2:]
    x = resp.reshape(-1, 1, h, w)
    mx = F.max_pool2d(x, 3, stride=1, padding=1)
    idx = torch.arange(h * w, device=resp.device,
                       dtype=torch.float32).reshape(1, 1, h, w)
    at_max = x >= mx
    cand = torch.where(at_max, idx, torch.full_like(idx, float("inf")))
    keep = at_max & (idx == -F.max_pool2d(-cand, 3, stride=1, padding=1))
    return torch.where(keep, x, torch.zeros_like(x)).reshape(resp.shape)


def stable_topk(x, k):
    """The k largest along the last dim, ties to the smaller index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def thresholds(cfg: dict) -> dict:
    """Each algorithm's absolute response threshold on [0, 1] pixels: the
    paper's are on 8-bit ones, rescaled as the response scales."""
    spo = cfg["scales_per_octave"]
    sift_thr = cfg["sift_contrast_threshold"] / spo
    return {"harris": cfg["harris_threshold"] * 1e-4,
            "shi_tomasi": cfg["shi_tomasi_threshold"] * 1e-2,
            "sift": sift_thr,
            "surf": cfg["surf_hessian_threshold"] / 255.0 ** 2,
            "fast": 0.0, "brief": 0.0, "orb": 0.0}


def response(alg, img, cfg):
    if alg == "harris":
        return harris(img, cfg["harris_k"])
    if alg == "shi_tomasi":
        return shi_tomasi(img)
    if alg == "sift":
        spo = cfg["scales_per_octave"]
        return sift(img, spo, cfg["sift_contrast_threshold"] / spo)
    if alg == "surf":
        return surf(img)
    return fast(img, cfg["fast_threshold"], cfg["fast_arc"])


DESCRIBE = {"sift": sift_desc, "surf": surf_desc, "brief": brief_desc,
            "orb": orb_desc}
SHARED = {"brief": "fast", "orb": "fast"}     # same response map as FAST


def per_tile(tiles, headers, algorithms, cfg):
    """Each algorithm's per-tile features of one block of tiles: count,
    top-K (ys, xs in scene coordinates, scores, valid) and descriptors."""
    tile, halo, k = cfg["tile"], cfg["halo"], cfg["max_keypoints_per_tile"]
    thr = thresholds(cfg)
    h, w = tiles.shape[-2:]
    ys_ = torch.arange(h, device=tiles.device)
    xs_ = torch.arange(w, device=tiles.device)
    my = (ys_ >= halo) & (ys_ < halo + headers[:, 3:4])
    mx = (xs_ >= halo) & (xs_ < halo + headers[:, 4:5])
    mask = my[:, :, None] & mx[:, None, :] & (headers[:, 5] == 0)[:, None,
                                                                  None]
    maps, out = {}, {}
    for alg in algorithms:
        key = SHARED.get(alg, alg)
        if key not in maps:
            maps[key] = response(alg, tiles, cfg)
        resp = maps[key]
        t = f32(thr[alg])
        keep = mask & (resp > t)
        count = keep.sum(dim=(-2, -1), dtype=torch.int32)
        cand = nms3x3(resp)
        keep = mask & (cand > t)
        flat = torch.where(keep, cand, torch.full_like(cand, float("-inf")))
        scores, idx = stable_topk(flat.reshape(flat.shape[0], h * w), k)
        valid = torch.isfinite(scores)
        scores = torch.where(valid, scores, torch.zeros_like(scores))
        ys = torch.div(idx, w, rounding_mode="floor").to(torch.int32)
        xs = (idx % w).to(torch.int32)
        feats = {"count": count, "scores": scores, "valid": valid,
                 "ys": headers[:, 1:2] * tile + (ys - halo),
                 "xs": headers[:, 2:3] * tile + (xs - halo)}
        if alg in DESCRIBE:
            d = DESCRIBE[alg](tiles, ys, xs)
            feats["desc"] = torch.where(valid[..., None], d,
                                        torch.zeros_like(d))
        out[alg] = feats
    return out


def reduce(feats):
    """Total count and the global top 4K over all tiles (invalid slots at
    -inf, ties to the smaller flat index)."""
    t, k = feats["scores"].shape
    masked = torch.where(feats["valid"].reshape(-1),
                         feats["scores"].reshape(-1),
                         torch.full_like(feats["scores"].reshape(-1),
                                         float("-inf")))
    top, idx = stable_topk(masked, min(4 * k, t * k))
    finite = torch.isfinite(top)

    def gather(a):
        return a.reshape(t * k, *a.shape[2:])[idx]
    out = {"total_count": feats["count"].sum(),
           "per_tile_count": feats["count"],
           "top_scores": torch.where(finite, top, torch.zeros_like(top)),
           "top_ys": gather(feats["ys"]), "top_xs": gather(feats["xs"]),
           "top_valid": gather(feats["valid"]) & finite,
           "keypoint_count": feats["valid"].sum()}
    if "desc" in feats:
        out["top_desc"] = gather(feats["desc"])
    return out


@torch.no_grad()
def extract(tiles, headers, algorithms, cfg: dict, dtype=torch.float32,
            block: int = 64):
    """The scene's result per algorithm, on the host: tiles [N, H, W] and
    headers [N, 6] (scene, ty, tx, valid_h, valid_w, pad) on any device,
    computed ``block`` tiles at a time in ``dtype``."""
    parts = []
    for i in range(0, tiles.shape[0], block):
        parts.append(per_tile(tiles[i:i + block].to(dtype),
                              headers[i:i + block].to(torch.int32),
                              algorithms, cfg))
    out = {}
    for alg in algorithms:
        joined = {key: torch.cat([p[alg][key] for p in parts])
                  for key in parts[0][alg]}
        out[alg] = {key: v.cpu() for key, v in reduce(joined).items()}
    return out
