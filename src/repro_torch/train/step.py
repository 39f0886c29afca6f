"""The training step (port of ``repro.train.step``): the model's
``loss`` differentiated by autograd + AdamW, with optional microbatch
gradient accumulation and optional gradient compression with error
feedback.

State layout, the reference's (a flat tree of tensors, so checkpointing
stays trivial):
    {"params": {name: tensor}, "opt": {"m", "v", "count"}, "step": int32
     [, "err": {name: tensor}]}
``params`` are the model's own parameters, keyed by their module names
(the reference's paths with the stacked axes spelled out, as
``convert.lm_params_from_reference`` names them); the step updates them,
the moments and ``step`` in place and returns the state.

On a mesh (``sharding.use_mesh``) the state's tensors are DTensors.  A
gradient comes back with the placements autograd gives it (``Partial`` on
the axes its weight was gathered over) and is redistributed to its
parameter's before the clip; a microbatch is a slice of the global batch,
sharded as the batch is; the metrics come back as plain tensors, the same
on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.distributed.sharding import local_shard
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compression import compress_decompress


@dataclass(frozen=True)
class TrainStepConfig:
    learning_rate: float = 3e-4
    microbatches: int = 1            # grad accumulation steps
    grad_compression: bool = False   # int8 + error feedback


def make_init_fn(model, optimizer: AdamW, step_cfg: TrainStepConfig):
    """``init_fn(generator)``: draws the model's weights from ``generator``
    and returns the state around them."""
    def init_fn(generator: torch.Generator):
        model.init(generator)
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        state = {"params": params, "opt": optimizer.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if step_cfg.grad_compression:
            state["err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for k, p in params.items()}
        return state
    return init_fn


def _rows(v, lo, hi):
    """Rows [lo, hi) of a batch leaf; of a DTensor, sharded as it is."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(v, DTensor):
        return v[lo:hi]
    return distribute_tensor(v.full_tensor()[lo:hi], v.device_mesh,
                             v.placements)


def _split_microbatches(batch, n):
    size = next(iter(batch.values())).shape[0] // n
    return [{k: _rows(v, i * size, (i + 1) * size) for k, v in batch.items()}
            for i in range(n)]


def _as_param(g, p):
    """A gradient brought to its parameter's placements."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value(t):
    """A metric as a plain tensor (a DTensor's global value)."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(model, optimizer: AdamW, step_cfg: TrainStepConfig,
                    lr_fn: Optional[Callable] = None):
    lr_fn = lr_fn or (lambda step: step_cfg.learning_rate)

    def grad_fn(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return (_value(loss.detach()),
                {k: _value(v.detach()) for k, v in metrics.items()},
                {k: _as_param(g, p) for (k, p), g in zip(params.items(),
                                                          grads)})

    def train_step(state, batch):
        params = state["params"]
        n = step_cfg.microbatches
        if n > 1:
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=local_shard(state["step"]).device)
            for mb in _split_microbatches(batch, n):
                mb_loss, metrics, g = grad_fn(params, mb)
                for k, gk in g.items():
                    grads[k].add_(gk.float())
                loss = loss + mb_loss
                del g
            loss = loss / n
            for g in grads.values():
                g.div_(n)
        else:
            loss, metrics, grads = grad_fn(params, batch)

        if step_cfg.grad_compression:
            grads, state["err"] = compress_decompress(grads, state["err"])

        lr = lr_fn(local_shard(state["step"]))
        _, state["opt"], gnorm = optimizer.update(grads, state["opt"],
                                                  params, lr)
        state["step"] = state["step"] + 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=torch.as_tensor(lr, dtype=torch.float32))
        return state, metrics

    return train_step
