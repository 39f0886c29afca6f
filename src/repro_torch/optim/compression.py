"""Gradient compression with error feedback (port of
``repro.optim.compression``): per-tensor int8 with one fp32 scale,
quantize then dequantize, the rounding error carried into the next step
(fp32).  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
from __future__ import annotations

import torch


def _q(g, err):
    gf = g.float() + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq.to(g.dtype), gf - deq


def compress_decompress(grads: dict, error_state):
    """Returns (dequantized grads, new error feedback state), both keyed as
    ``grads``; ``error_state`` None starts from zeros."""
    if error_state is None:
        error_state = {k: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device)
                       for k, g in grads.items()}
    out = {k: _q(g, error_state[k]) for k, g in grads.items()}
    return ({k: d for k, (d, _) in out.items()},
            {k: e for k, (_, e) in out.items()})
