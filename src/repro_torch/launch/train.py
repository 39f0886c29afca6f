"""End-to-end LM training launcher with checkpoint/restart (port of
``repro/launch/train.py``).  Runs on the CUDA card unless ``--device cpu``
is given; there is no mesh (one device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 300 --batch 8 --seq 256 [--reduced] \\
        [--ckpt-dir DIR --ckpt-every N [--resume]]

``--reduced`` takes the arch's tiny same-family config (remat off), as the
reference's CPU runs do; the weights come from
``torch.Generator(device).manual_seed(0)`` and step i's batch from
``synthetic_lm_batch(seed=i)``, so a resumed run continues the
uninterrupted one.  ``main`` returns the losses of the steps it ran.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, flatten_state
from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.data.tokens import synthetic_lm_batch
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

    dev = resolve_device(args.device)
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

    state = init_fn(torch.Generator(device=dev).manual_seed(0))
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        restored, start = ckpt.restore(state)
        with torch.no_grad():
            for (_, dst), (_, src) in zip(flatten_state(state),
                                          flatten_state(restored)):
                dst.copy_(src)
        print(f"[resume] restored step {start}")
    print(f"[train] {cfg.arch_id} reduced={args.reduced} "
          f"params={param_count(model):,}")
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
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if i % args.log_every == 0 or i == args.steps - 1:
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
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"[done] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
