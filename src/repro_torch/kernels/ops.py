"""Public wrappers of the four CUDA kernels (``repro/kernels/ops.py``'s
counterparts): ``harris``, ``gaussian_blur``, ``fast_score`` and
``scalespace_octave`` accept ``[H, W]`` or ``[N, H, W]`` (the blur any
``[..., H, W]``) and return the same rank.  The kernels reflect-pad by index
themselves, so the reference's host-side pad and its TPU-only 128-lane edge
pad have no counterpart here; neither changes the cropped output.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import blur as _blur
from repro_torch.kernels import fastscore as _fast
from repro_torch.kernels import harris as _harris
from repro_torch.kernels import ref
from repro_torch.kernels import scalespace as _scalespace

KERNELS = {
    "harris": _harris.KERNEL,
    "fast": _fast.KERNEL,
    "blur": _blur.KERNEL,
    "scalespace": _scalespace.KERNEL,
}


def launch_counts() -> dict:
    """{kernel name: launches so far} for the four kernels."""
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _as3d(img: torch.Tensor):
    x = img.reshape((-1,) + tuple(img.shape[-2:])).float().contiguous()
    return x, lambda out: out.reshape(img.shape)


def harris(img: torch.Tensor, *, k: float = 0.04, sigma: float = 1.0,
           shi_tomasi: bool = False) -> torch.Tensor:
    """Fused Harris / Shi-Tomasi response.  img [H,W] or [N,H,W] -> same."""
    x, back = _as3d(img)
    return back(_harris.harris(x, k=k, sigma=sigma, shi_tomasi=shi_tomasi))


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur.  img [..., H, W] (leading dims flattened)."""
    x, back = _as3d(img)
    return back(_blur.blur(x, sigma))


def fast_score(img: torch.Tensor, *, threshold: float = 0.15,
               arc: int = 9) -> torch.Tensor:
    """FAST-N corner score.  img [H,W] or [N,H,W] -> same."""
    x, back = _as3d(img)
    return back(_fast.fast_score(x, threshold=threshold, arc=arc))


def scalespace_octave(base: torch.Tensor, *, scales_per_octave: int,
                      contrast_threshold: float, sigma0: float = 1.6):
    """Fused SIFT octave: (extrema response, next-octave seed level).
    ``base`` [H,W] or [N,H,W], already blurred to ``sigma0``."""
    x, back = _as3d(base)
    resp, seed = _scalespace.scalespace_octave(
        x, scales_per_octave=scales_per_octave,
        contrast_threshold=contrast_threshold, sigma0=sigma0)
    return back(resp), back(seed)


def scalespace_pad(scales_per_octave: int, sigma0: float = 1.6) -> int:
    """The fused octave's one-time padding: cumulative blur radius + 1."""
    return sum((len(t) - 1) // 2
               for t in ref.scalespace_taps(scales_per_octave, sigma0)) + 1


# The JAX reference's octave-fusion rule, byte for byte
# (repro/kernels/ops.py::scalespace_fits_vmem, a 12 MiB TPU VMEM budget with
# 128-lane alignment).  Kept so that the port computes the same maps as the
# reference; it is not a limit of this card.
_REFERENCE_LANE = 128
_REFERENCE_BUDGET_BYTES = 12 * 2 ** 20


def reference_fuses_octave(h: int, w: int, scales_per_octave: int,
                           sigma0: float = 1.6) -> bool:
    """True where the reference runs an ``[h, w]`` SIFT octave through its
    fused pad-once kernel; elsewhere it runs the per-level path."""
    p = scalespace_pad(scales_per_octave, sigma0)
    wp = w + 2 * p
    wp += (-wp) % _REFERENCE_LANE
    slab = (h + 2 * p) * wp * 4
    n_levels = scales_per_octave + 3
    return (2 * n_levels + 2 + 4) * slab <= _REFERENCE_BUDGET_BYTES
