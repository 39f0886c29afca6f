"""Gradient compression with error feedback (port of
``repro.optim.compression``): per-tensor int8 with one fp32 scale,
quantize then dequantize, the rounding error carried into the next step
(fp32).  ``torch.round`` rounds half to even, as ``jnp.round`` does.

On a mesh a gradient and its error are DTensors of one placement: the
quantization runs on the local shards, and the per-tensor ``abs().max()``
is the maximum over the mesh axes the tensor is sharded over (a maximum
rounds nothing, so the scale is one device's)."""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (like, local_shard,
                                              reduce_partial, sharded_axes)


def _q(g, err):
    gf = local_shard(g).float() + local_shard(err)
    amax = reduce_partial(gf.abs().max(), getattr(g, "device_mesh", None),
                          sharded_axes(g), "max")
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return like(deq.to(g.dtype), g), like(gf - deq, err)


def compress_decompress(grads: dict, error_state):
    """Returns (dequantized grads, new error feedback state), both keyed as
    ``grads``; ``error_state`` None starts from zeros."""
    if error_state is None:
        error_state = {k: torch.zeros_like(
            g, dtype=torch.float32, memory_format=torch.contiguous_format)
                       for k, g in grads.items()}
    out = {k: _q(g, error_state[k]) for k, g in grads.items()}
    return ({k: d for k, (d, _) in out.items()},
            {k: e for k, (_, e) in out.items()})
