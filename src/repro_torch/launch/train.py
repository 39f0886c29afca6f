"""End-to-end LM training launcher with checkpoint/restart (port of
``repro/launch/train.py``).  Runs on the CUDA card unless ``--device cpu``
is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 300 --batch 8 --seq 256 [--reduced] \\
        [--ckpt-dir DIR --ckpt-every N [--resume]]
    torchrun --nproc-per-node 4 -m repro_torch.launch.train ...

Launched plainly it trains on one device.  Launched under ``torchrun`` (or
with a process group already joined) it trains on the (world, 1) host mesh
(`mesh.make_lm_host_mesh`: NCCL on the cards, one a rank; gloo with
``--device cpu``) under ``use_mesh`` and ``activation_dp_over_model``, as
the reference's mesh branch does.  The reference leaves the parameters'
placement to XLA's propagation from its sharded activations; here the
state is placed by ``specs.state_pspecs`` (the parameter rules), and each
step's batch by ``specs.batch_pspecs``.  Every rank draws the same weights
and batches; rank 0 prints and writes the checkpoints (the logical
tensors, which any mesh restores).

``--reduced`` takes the arch's tiny same-family config (remat off), as the
reference's CPU runs do; the weights come from
``torch.Generator(device).manual_seed(0)`` and step i's batch from
``synthetic_lm_batch(seed=i)``, so a resumed run continues the
uninterrupted one.  ``main`` returns the losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, flatten_state
from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import specs as SP
from repro_torch.launch.mesh import make_lm_host_mesh
from repro_torch.models import build_model
from repro_torch.models.model import param_count
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train.step import (TrainStepConfig, make_init_fn,
                                    make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    mesh = None
    if "WORLD_SIZE" in os.environ or _joined():
        mesh = make_lm_host_mesh(args.device)
        dev = (torch.device("cpu") if mesh.device_mesh.device_type == "cpu"
               else torch.device("cuda", torch.cuda.current_device()))
    else:
        dev = resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(remat="nothing" if args.reduced else cfg.remat)
    model = build_model(cfg, dev)
    opt = AdamW()
    scfg = TrainStepConfig(learning_rate=args.lr,
                           microbatches=args.microbatches,
                           grad_compression=args.grad_compression)
    lr_fn = cosine_schedule(args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model, opt, scfg, lr_fn)
    init_fn = make_init_fn(model, opt, scfg)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    with _on_mesh(mesh, cfg):
        gen = torch.Generator(device=dev).manual_seed(0)
        shardings = None
        if mesh is None:
            state = init_fn(gen)
        else:
            model.init(gen)
            state, shardings = place_state(model, opt, scfg, mesh)
        start = 0
        if ckpt and args.resume and ckpt.latest_step() is not None:
            restored, start = ckpt.restore(state, shardings=shardings,
                                           mesh=mesh)
            with torch.no_grad():
                for (_, dst), (_, src) in zip(flatten_state(state),
                                              flatten_state(restored)):
                    dst.copy_(src)
            if lead:
                print(f"[resume] restored step {start}")
        if lead:
            print(f"[train] {cfg.arch_id} reduced={args.reduced} "
                  f"params={param_count(model):,}"
                  + (f" mesh={mesh.shape}" if mesh is not None else ""))
        t0 = time.time()
        losses = []
        for i in range(start, args.steps):
            batch = synthetic_lm_batch(args.batch, args.seq, cfg.vocab_size,
                                       seed=i)
            batch = {k: torch.from_numpy(v).long().to(dev)
                     for k, v in batch.items()}
            if cfg.n_image_patches:
                batch["patches"] = torch.zeros(
                    (args.batch, cfg.n_image_patches, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            if cfg.is_enc_dec:
                batch["frames"] = torch.zeros(
                    (args.batch, cfg.encoder_seq_len, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            if mesh is not None:
                batch = SH.distribute(batch, SP.to_named(
                    SP.batch_pspecs(batch, mesh), mesh), mesh)
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if lead and (i % args.log_every == 0 or i == args.steps - 1):
                dt = time.time() - t0
                print(f"step {i:5d} loss {losses[-1]:.4f} "
                      f"ce {float(metrics['ce']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt:.1f}s)", flush=True)
            if ckpt and (i + 1) % args.ckpt_every == 0:
                ckpt.save(state, i + 1, async_=True)
        if ckpt:
            ckpt.save(state, args.steps, async_=True)
            ckpt.wait()
            if mesh is not None:
                torch.distributed.barrier()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    if lead:
        print(f"[done] loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


def _joined() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def _on_mesh(mesh, cfg):
    """The reference's mesh context (``use_mesh``, ``activation_dp_over_
    model``), with DTensor's implicit replication of the plain tensors a
    model makes (masks, positions); nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    ctx = contextlib.ExitStack()
    ctx.enter_context(SH.use_mesh(mesh))
    ctx.enter_context(SH.activation_dp_over_model(cfg.dp_over_model))
    ctx.enter_context(implicit_replication())
    return ctx


def place_state(model, opt, scfg, mesh):
    """The train state of ``make_init_fn`` on ``mesh``, placed by
    ``specs.state_pspecs``: the model's weights (the same on every rank,
    drawn as one device draws them) each cut to its shard, then the
    moments and counters made in place (a full-width state need never fit
    one card).  Returns (state, its placements)."""
    shardings = SP.to_named(SP.state_pspecs(
        SP.state_abstract(model, opt, scfg), mesh), mesh)
    SH.shard_module(model, mesh, shardings["params"])
    params = dict(model.named_parameters())
    dev = SH.local_shard(next(iter(params.values()))).device

    def zero(placements):
        return SH.distribute(torch.zeros((), dtype=torch.int32, device=dev),
                             placements, mesh)
    state = {"params": params,
             "opt": dict(opt.init(params),
                         count=zero(shardings["opt"]["count"])),
             "step": zero(shardings["step"])}
    if scfg.grad_compression:
        state["err"] = {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in params.items()}
    return state, shardings


if __name__ == "__main__":
    main()
