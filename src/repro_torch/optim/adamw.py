"""AdamW with fp32 moments, decoupled weight decay and global-norm clipping
(port of ``repro.optim.adamw``).

Parameters, gradients and moments are dicts of tensors keyed by parameter
name.  As in the reference, the moments ``m``, ``v`` are float32 whatever
the parameter's dtype, there is no fp32 master copy (each step computes the
new parameter in fp32 and rounds it to the parameter's dtype), clipping
rounds the scaled gradient back to its own dtype before the moments see it,
and weight decay is added to the step of matrices only (``ndim >= 2``).
``torch.optim.AdamW`` differs on all three counts.

``update`` writes the moments and the parameters in place, a slab of
``SLAB`` elements at a time, so that a large tensor's fp32 temporaries
stay small; every operation is elementwise, so the slabs change no bit.

On a mesh the tensors are DTensors whose gradients carry their parameter's
placements: the slab loop runs on the local shards (elementwise, so every
sharding gives each element the same bits), and the global norm sums the
local shards' squares, then reduces each group of tensors sharded over the
same mesh axes across them.  Its rounding order then differs from one
device's (the mesh tests hold the step to 1e-5 in float32).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.sharding import (like, local_shard,
                                              reduce_partial, sharded_axes)

SLAB = 1 << 26


def _slabs(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), SLAB):
        yield flat[i:i + SLAB]


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (a
    leaf's sum taken a slab at a time).  DTensor leaves: the local shards'
    sums, added up per group of leaves sharded over the same mesh axes,
    each group reduced over its axes, the groups added in order."""
    groups, mesh = {}, None
    for g in grads.values():
        axes = sharded_axes(g)
        if axes:
            mesh = g.device_mesh
        for gs in _slabs(local_shard(g).contiguous()):
            gf = gs.float()
            s = torch.sum(gf * gf)
            groups[axes] = s if axes not in groups else groups[axes] + s
    total = None
    for axes, s in groups.items():
        s = reduce_partial(s, mesh, axes)
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """Returns (grads scaled by min(1, max_norm / max(gn, 1e-9)), each
    rounded back to its dtype; gn)."""
    gn = global_norm(grads)
    scale = clip_scale(gn, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params: dict) -> dict:
        """fp32 zeros like each parameter (DTensors of its placements on a
        mesh) and an int32 step count."""
        dev = local_shard(next(iter(params.values()))).device
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict, lr):
        """One step: clip ``grads``, update ``state``'s moments and
        ``params`` in place.  ``lr``: a float or a float32 scalar tensor.
        Returns (params, state, the global norm before clipping)."""
        gn = global_norm(grads)
        scale = clip_scale(gn, self.max_grad_norm)
        count = local_shard(state["count"]) + 1
        cf = count.float()
        b1c = 1.0 - torch.pow(self.b1, cf)
        b2c = 1.0 - torch.pow(self.b2, cf)
        lr = local_shard(lr) if isinstance(lr, torch.Tensor) else lr
        for k, p in params.items():
            g = local_shard(grads[k]).contiguous()
            decay = p.dim() >= 2
            for gs, ms, vs, ps in zip(_slabs(g),
                                      _slabs(local_shard(state["m"][k])),
                                      _slabs(local_shard(state["v"][k])),
                                      _slabs(local_shard(p))):
                gf = (gs.float() * scale).to(gs.dtype).float()
                ms.mul_(self.b1).add_((1 - self.b1) * gf)
                vs.mul_(self.b2).add_((1 - self.b2) * gf * gf)
                step = (ms / b1c) / (torch.sqrt(vs / b2c) + self.eps)
                pf = ps.float()
                if decay:
                    step = step + self.weight_decay * pf
                ps.copy_(pf - lr * step)
        count = like(count, state["count"])
        return params, {"m": state["m"], "v": state["v"], "count": count}, gn
