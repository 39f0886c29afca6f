"""Batched greedy decoding with a KV / state cache on the PyTorch port, on
reduced configs: the steps of ``examples/serve_lm.py``, on the CUDA card by
default or on the CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
        [--steps N]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.lm import greedy_generate

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
ap.add_argument("--steps", type=int, default=16)
args = ap.parse_args()
dev = resolve_device(args.device)

with torch.inference_mode():
    for arch in ("smollm-135m", "xlstm-350m", "zamba2-2.7b"):
        cfg = get_config(arch).reduced().replace(remat="nothing")
        model = build_model(cfg, dev).init(
            torch.Generator(device=dev).manual_seed(0))
        prompt = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (4, 8))).long().to(dev)   # a batch of 4 requests
        t0 = time.time()
        out = greedy_generate(model, prompt, n_steps=args.steps)
        dt = time.time() - t0
        print(f"{arch:14s} generated {tuple(out.shape)} tokens in {dt:.1f}s "
              f"(batched greedy, KV/state cache)")
        print(f"   first request: {out[0].tolist()}")
