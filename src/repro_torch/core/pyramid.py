"""Gaussian scale space and DoG extrema (SIFT/SURF substrate), on tensors.

Port of ``repro/core/pyramid.py``.  Every function takes ``[..., H, W]``
tensors and keeps the reference's arithmetic order (taps summed in order,
W pass then H pass), so values agree with the JAX package to an ulp or two
and thresholded masks agree exactly.  With ``use_kernels=True`` the blur and
the fused octave go through the CUDA kernels of ``repro_torch.kernels``
(their plain twins for a CPU tensor).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.padding import reflect_indices, reflect_pad


def f32(x: float) -> float:
    """A Python scalar rounded to float32, as JAX rounds a weak-typed scalar
    in a float32 op and as the CUDA kernels receive it."""
    return float(np.float32(x))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded to nearest, as ``__fsqrt_rn``, numpy
    and XLA give it: torch's vectorized CPU ``sqrt`` is off by an ulp on
    some inputs, and the float64 root rounds to the right float32."""
    return torch.sqrt(x.double()).float()


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(sigma: float, radius: int = 0) -> np.ndarray:
    if radius == 0:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def blur_valid(x: torch.Tensor, taps, h: int, w: int) -> torch.Tensor:
    """Valid separable blur of a slab padded by r = len(taps)//2 -> [..., h, w].

    W pass then H pass, each a left-to-right sum of ``tap * shifted slab``
    with one rounding per multiply and per add (no fused multiply-add), the
    order the CUDA kernels reproduce bit for bit."""
    n = len(taps)
    tmp = float(taps[0]) * x[..., :, 0:w]
    for j in range(1, n):
        tmp = tmp + float(taps[j]) * x[..., :, j:j + w]
    out = float(taps[0]) * tmp[..., 0:h, :]
    for i in range(1, n):
        out = out + float(taps[i]) * tmp[..., i:i + h, :]
    return out


def blur_separable(img: torch.Tensor, sigma: float,
                   use_kernels: bool = False) -> torch.Tensor:
    """img [..., H, W] -> gaussian blurred (reflect padding by the radius)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.gaussian_blur(img, sigma)
    taps = gaussian_kernel_1d(float(sigma))
    r = (len(taps) - 1) // 2
    h, w = img.shape[-2:]
    return blur_valid(reflect_pad(img, r), taps, h, w)


def blur_separable_seed(img: torch.Tensor, sigma: float,
                        use_kernels: bool = False) -> torch.Tensor:
    """The seed's blur formulation: reflect-pad per pass, taps along the
    last dim, transposed between passes.  The same arithmetic as
    `blur_separable`, in the same order, hence bitwise equal to it; kept as
    the level-by-level baseline (`gaussian_pyramid`,
    `detectors.sift_dog_response_levelwise`)."""
    if use_kernels:
        from repro_torch.kernels import ops
        return ops.gaussian_blur(img, sigma)
    taps = gaussian_kernel_1d(float(sigma))
    r = (len(taps) - 1) // 2

    def conv_last(x):
        n = x.shape[-1]
        xp = x.index_select(-1, reflect_indices(n, r, r, x.device))
        out = float(taps[0]) * xp[..., 0:n]
        for i in range(1, len(taps)):
            out = out + float(taps[i]) * xp[..., i:i + n]
        return out

    out = conv_last(img)                                   # along W
    return conv_last(out.transpose(-1, -2)).transpose(-1, -2)   # along H


def downsample2(img: torch.Tensor) -> torch.Tensor:
    return img[..., ::2, ::2]


@functools.lru_cache(maxsize=32)
def octave_increments(scales_per_octave: int, sigma0: float = 1.6):
    """Incremental blur sigmas for one octave's levels 1..n_scales-1.

    Level s has total sigma ``sigma0 * 2**(s/scales_per_octave)``; each level
    is produced from the previous by a blur of the returned increment (the
    Gaussian semigroup property)."""
    n_scales = scales_per_octave + 3
    k = 2.0 ** (1.0 / scales_per_octave)
    incs = []
    sigma_prev = sigma0
    for s in range(1, n_scales):
        sigma_total = sigma0 * (k ** s)
        incs.append(float(np.sqrt(max(sigma_total ** 2 - sigma_prev ** 2,
                                      1e-6))))
        sigma_prev = sigma_total
    return tuple(incs)


def _ring8_and_full9(dog_level: torch.Tensor):
    """3x3 neighbourhood extremes of one DoG level [..., H, W] (reflect pad 1).

    Returns (full9_max, full9_min, ring8_max, ring8_min): max/min over the
    full 3x3 window and over the 8-neighbour ring (centre excluded), by
    separable shifted chains — exact, since max and min are associative."""
    h, w = dog_level.shape[-2:]
    p = reflect_pad(dog_level, 1)
    c0, c1, c2 = p[..., :, 0:w], p[..., :, 1:w + 1], p[..., :, 2:w + 2]
    h3mx = torch.maximum(torch.maximum(c0, c1), c2)         # [..., h+2, w]
    h3mn = torch.minimum(torch.minimum(c0, c1), c2)
    lrmx = torch.maximum(c0, c2)
    lrmn = torch.minimum(c0, c2)

    def row(y, a):
        return a[..., y:y + h, :]

    full9_max = torch.maximum(torch.maximum(row(0, h3mx), row(1, h3mx)),
                              row(2, h3mx))
    full9_min = torch.minimum(torch.minimum(row(0, h3mn), row(1, h3mn)),
                              row(2, h3mn))
    ring8_max = torch.maximum(torch.maximum(row(0, h3mx), row(2, h3mx)),
                              row(1, lrmx))
    ring8_min = torch.minimum(torch.minimum(row(0, h3mn), row(2, h3mn)),
                              row(1, lrmn))
    return full9_max, full9_min, ring8_max, ring8_min


def fused_extrema_response(dogs, contrast_threshold: float) -> torch.Tensor:
    """Max over mid scales of |DoG| where the pixel is a strict 3x3x3
    scale-space extremum above the contrast threshold, else 0."""
    stats = [_ring8_and_full9(d) for d in dogs]
    resp = None
    for s in range(1, len(dogs) - 1):
        below_mx, below_mn, _, _ = stats[s - 1]
        above_mx, above_mn, _, _ = stats[s + 1]
        _, _, ring_mx, ring_mn = stats[s]
        mid = dogs[s]
        neigh_max = torch.maximum(torch.maximum(below_mx, above_mx), ring_mx)
        neigh_min = torch.minimum(torch.minimum(below_mn, above_mn), ring_mn)
        is_ext = (mid > neigh_max) | (mid < neigh_min)
        a = mid.abs()
        r = torch.where(is_ext & (a > f32(contrast_threshold)), a,
                        torch.zeros_like(a))
        resp = r if resp is None else torch.maximum(resp, r)
    return resp


def fused_octave_response(base: torch.Tensor, scales_per_octave: int,
                          contrast_threshold: float, sigma0: float = 1.6,
                          use_kernels: bool = False):
    """One octave of the SIFT detector: (response, next-octave seed).

    ``base`` [..., H, W] is the octave's level 0 (already blurred to
    ``sigma0``).  ``seed`` is the level with total sigma ``2*sigma0``.

    With ``use_kernels`` the octave takes the fused pad-once scale-space
    kernel exactly where the JAX reference takes its fused Pallas kernel
    (``ops.reference_fuses_octave``); elsewhere it is the per-level path:
    reflect-pad per level, each incremental blur through the blur kernel.
    The two conventions differ near the tile edge, so keeping the
    reference's choice keeps the port's maps equal to the reference's."""
    if use_kernels:
        from repro_torch.kernels import ops
        h, w = base.shape[-2:]
        if ops.reference_fuses_octave(h, w, scales_per_octave, sigma0):
            return ops.scalespace_octave(
                base, scales_per_octave=scales_per_octave,
                contrast_threshold=float(contrast_threshold), sigma0=sigma0)
    prev = base
    seed = None
    dogs = []
    for s, sigma_inc in enumerate(octave_increments(scales_per_octave, sigma0),
                                  start=1):
        cur = blur_separable(prev, sigma_inc, use_kernels)
        dogs.append(cur - prev)
        if s == scales_per_octave:
            seed = cur
        prev = cur
    return fused_extrema_response(dogs, contrast_threshold), seed


def gaussian_pyramid(img: torch.Tensor, n_octaves: int,
                     scales_per_octave: int, sigma0: float = 1.6,
                     use_kernels: bool = False, blur_fn=None):
    """The level-by-level scale space: a list of octaves, each [...,
    scales_per_octave + 3, H_o, W_o], every level a tensor of its own (the
    SIFT path takes `fused_octave_response` instead).  ``blur_fn`` pins the
    blur formulation (`blur_separable_seed` for the seed's baseline); by
    default `blur_separable`.  Each octave seeds the next from its level of
    total sigma ``2 * sigma0``."""
    blur_fn = blur_separable if blur_fn is None else blur_fn
    octaves = []
    base = blur_fn(img, sigma0, use_kernels)
    for _ in range(n_octaves):
        levels = [base]
        for sigma_inc in octave_increments(scales_per_octave, sigma0):
            levels.append(blur_fn(levels[-1], sigma_inc, use_kernels))
        octaves.append(torch.stack(levels, dim=-3))
        base = downsample2(levels[scales_per_octave])
    return octaves


def dog_pyramid(octaves):
    """Difference-of-Gaussians per octave: [..., n_scales - 1, H, W]."""
    return [o[..., 1:, :, :] - o[..., :-1, :, :] for o in octaves]


def sobel_valid(x: torch.Tensor, h: int, w: int):
    """Sobel gradients (divided by 8) of a slab padded by 1 -> [..., h, w]."""
    def sl(dy, dx):
        return x[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1)) / 8.0
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1)) / 8.0
    return gx, gy


def sobel_gradients(img: torch.Tensor):
    """img [..., H, W] -> (gx, gy), Sobel, reflect padding."""
    h, w = img.shape[-2:]
    return sobel_valid(reflect_pad(img, 1), h, w)


_SCAN_BLOCK = 16


def _blocked_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float scan in the reference's summation order.

    ``jnp.cumsum`` lowers (XLA's reduce-window rewrite) to a sequential scan
    inside blocks of 16, a recursive scan of the block totals, and one add
    of each block's exclusive prefix.  Reproducing that grouping makes the
    float32 integral image bitwise equal to the reference's, which keeps
    SURF's thresholded box-filter response (a difference of large sums)
    identical.  ``torch.cumsum`` groups differently and would not."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out.movedim(-1, dim)
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    inner = _blocked_cumsum(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK), -1)
    prefix = _blocked_cumsum(inner[..., -1], -1)
    excl = torch.nn.functional.pad(prefix[..., :-1], (1, 0))
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], nb * _SCAN_BLOCK)
    return out[..., :n].movedim(-1, dim)


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """Summed-area table with a leading zero row/col: [..., H+1, W+1]."""
    ii = _blocked_cumsum(_blocked_cumsum(img, -2), -1)
    return torch.nn.functional.pad(ii, (1, 0, 1, 0))


def box_sum(ii: torch.Tensor, y0: int, x0: int, h: int, w: int) -> torch.Tensor:
    """Box sums from an integral image, static offsets (for SURF filters).

    ii: [..., H+1, W+1]; returns [..., H, W] where out[y,x] = sum of the
    (h, w) box whose top-left is at (y + y0, x + x0) — out-of-range reads
    clamp to the image border."""
    H = ii.shape[-2] - 1
    W = ii.shape[-1] - 1

    def at(dy, dx):
        ys = (torch.arange(H, device=ii.device) + dy).clamp(0, H)
        xs = (torch.arange(W, device=ii.device) + dx).clamp(0, W)
        return ii.index_select(-2, ys).index_select(-1, xs)

    return (at(y0 + h, x0 + w) - at(y0, x0 + w)
            - at(y0 + h, x0) + at(y0, x0))
