"""Reflect padding by index map, with ``jnp.pad(mode="reflect")`` semantics.

``torch.nn.functional.pad(mode="reflect")`` raises when the pad is >= the
padded dimension; ``jnp.pad`` instead reflects again ("multi-bounce").  The
SIFT octave pads by 34 while the last octave of a small tile is narrower
than that, so the port pads by gathering through an index map.
"""
from __future__ import annotations

import torch


def reflect_indices(n: int, pad_before: int, pad_after: int,
                    device=None) -> torch.Tensor:
    """int64 ``[pad_before + n + pad_after]``: the source index in
    ``[0, n)`` of each padded position (even reflect, no edge repeat,
    multi-bounce for pads wider than the axis)."""
    if n == 1:
        return torch.zeros(pad_before + 1 + pad_after, dtype=torch.int64,
                           device=device)
    j = torch.arange(-pad_before, n + pad_after, device=device)
    period = 2 * (n - 1)
    j = j.abs() % period
    return torch.where(j >= n, period - j, j)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last two dims of ``x [..., H, W]`` by ``pad``."""
    h, w = x.shape[-2:]
    iy = reflect_indices(h, pad, pad, x.device)
    ix = reflect_indices(w, pad, pad, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)
