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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

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


def _split_microbatches(batch, n):
    return [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]


def make_train_step(model, optimizer: AdamW, step_cfg: TrainStepConfig,
                    lr_fn: Optional[Callable] = None):
    lr_fn = lr_fn or (lambda step: step_cfg.learning_rate)

    def grad_fn(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(state, batch):
        params = state["params"]
        n = step_cfg.microbatches
        if n > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
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

        lr = lr_fn(state["step"])
        _, state["opt"], gnorm = optimizer.update(grads, state["opt"],
                                                  params, lr)
        state["step"] = state["step"] + 1
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=torch.as_tensor(lr, dtype=torch.float32))
        return state, metrics

    return train_step
