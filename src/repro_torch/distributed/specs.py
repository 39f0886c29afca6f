"""Shape and sharding spec builders for the launchers and the dry run (port
of ``repro/distributed/specs.py``).

Everything here works on tensors of the ``meta`` device (or on fake ones
under ``FakeTensorMode``): no memory is allocated, so the full-size configs
can be specified for the production meshes.  A spec is a `P` per leaf of a
state, batch or cache tree (nested dicts of tensors, the port's layouts);
`to_named` turns a tree of specs into DTensor placements on a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import (
    P, _dp_over_model_active, dp_axes, largest_divisible_prefix,
    param_pspec_tree, placements,
)


def _data_axes(mesh):
    dp = dp_axes(mesh)
    if _dp_over_model_active() and "model" in mesh.axis_names:
        dp = dp + ("model",)
    return dp


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def _abstract(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def params_abstract(model) -> dict:
    """``{name: meta tensor}`` of a model's parameters (their shapes and
    dtypes; a model built on the ``meta`` device allocates nothing)."""
    return {k: _abstract(p) for k, p in model.named_parameters()}


def state_abstract(model, optimizer, step_cfg) -> dict:
    """The train state of ``train.step.make_init_fn`` as meta tensors: the
    parameters, fp32 moments, int32 counters and, with compression, the
    fp32 error feedback."""
    params = params_abstract(model)
    f32 = {k: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for k, p in params.items()}
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    state = {"params": params,
             "opt": {"m": f32, "v": dict(f32), "count": scalar},
             "step": scalar}
    if step_cfg.grad_compression:
        state["err"] = dict(f32)
    return state


def state_pspecs(state_shapes, mesh):
    """Params and the optimizer's m, v share the param rules; counters are
    replicated."""
    param_specs = param_pspec_tree(state_shapes["params"], mesh)
    out = {"params": param_specs,
           "opt": {"m": param_specs, "v": param_specs, "count": P()},
           "step": P()}
    if "err" in state_shapes:
        out["err"] = param_specs
    return out


# Per-device replicated-weight budget for serving params.  0 disables the
# feature, as in the reference (its decode collective was KV-gather
# dominated, not param gathers, so replication bought nothing).
SERVING_FSDP_BYTES_THRESHOLD = 0


def params_pspecs(params_shapes, mesh, serving: bool = False):
    """Parameter specs.  For serving, weights are replicated over the dp
    axes when they fit the per-device budget; large models keep FSDP."""
    specs = param_pspec_tree(params_shapes, mesh)
    if not serving:
        return specs
    model_sz = mesh.shape.get("model", 1)
    total_bytes = sum(int(np.prod(t.shape)) * t.element_size()
                      for t in params_shapes.values())
    if total_bytes / model_sz > SERVING_FSDP_BYTES_THRESHOLD:
        return specs                      # too big to replicate over dp
    dp = set(dp_axes(mesh))

    def drop_dp(spec):
        out = []
        for ax in tuple(spec):
            if ax is None:
                out.append(None)
            elif isinstance(ax, tuple):
                kept = tuple(a for a in ax if a not in dp)
                out.append(kept[0] if len(kept) == 1 else (kept or None))
            else:
                out.append(None if ax in dp else ax)
        return P(*out)

    return {k: drop_dp(s) for k, s in specs.items()}


def batch_pspecs(batch_shapes, mesh):
    """Shard the leading (batch) dim of every batch leaf on the dp axes
    (largest divisible prefix, so dp_over_model degrades gracefully)."""
    dp = _data_axes(mesh)

    def f(leaf):
        if not leaf.shape:
            return P()
        ax = largest_divisible_prefix(leaf.shape[0], dp, mesh)
        return P(ax, *([None] * (len(leaf.shape) - 1)))

    return _map(f, batch_shapes)


def cache_pspecs(cache_shapes, mesh, *, batch_size, max_seq, cfg):
    """Decode-cache sharding: the batch dim on dp when divisible, otherwise
    the sequence dim (long-context B=1: sequence-parallel KV).  KV-head dims
    shard on ``model`` when divisible, else the sequence dim does."""
    dp = _data_axes(mesh)
    model_sz = mesh.shape.get("model", 1)

    def f(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        used_dp = False
        for i, d in enumerate(shape):
            if d == batch_size and not used_dp:
                ax = largest_divisible_prefix(d, dp, mesh)
                if ax is not None:
                    spec[i] = ax
                    used_dp = True
                break
        if not used_dp and max_seq:
            for i, d in enumerate(shape):
                if d == max_seq:
                    ax = largest_divisible_prefix(d, dp, mesh)
                    if ax is not None:
                        spec[i] = ax
                        used_dp = True
                    break

        def _has_model(s):
            return s == "model" or (isinstance(s, tuple) and "model" in s)
        placed_model = any(_has_model(s) for s in spec)
        for i, d in enumerate(shape):
            if spec[i] is None and d in (cfg.n_kv_heads, cfg.n_heads) \
                    and i >= 2 and d % model_sz == 0:
                spec[i] = "model"
                placed_model = True
                break
        if not placed_model and max_seq:
            for i, d in enumerate(shape):
                if spec[i] is None and d == max_seq and d % model_sz == 0:
                    spec[i] = "model"
                    break
        return P(*spec)

    return _map(f, cache_shapes)


def to_named(tree, mesh):
    """A tree of `P` -> the same tree of DTensor placements on ``mesh``."""
    if isinstance(tree, dict):
        return {k: to_named(v, mesh) for k, v in tree.items()}
    return placements(tree, mesh)
