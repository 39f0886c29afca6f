"""Production-mesh dry run (port of ``repro/launch/dryrun.py``): trace one
train step, prefill or decode of every (architecture x input shape) on
rank 0 of the production mesh, with nothing allocated, and record memory,
per-rank op counts, collectives and the roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--multi-pod | --both-meshes] [--out build/dryrun]

The mesh is `make_production_mesh`'s: a fake process group of 256 (512)
ranks whose collectives move nothing; this process is rank 0, so what it
runs is one card's program.  The model, its state and the batch are fake
tensors (``FakeTensorMode``): shapes without memory, on the card's routes
(the bf16 GEMMs, ``MatmulF32``; ``analysis_flags.card_routes``).  They are
fake CUDA tensors where torch is built with CUDA, fake CPU tensors
elsewhere (a CPU-only build cannot run autograd on fake CUDA tensors).
`analysis.OpCounter` counts what the rank runs.  No card is needed.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, all_arch_ids, applicable_shapes, \
    get_config
from repro_torch.distributed import specs as SP
from repro_torch.distributed.sharding import (activation_dp_over_model,
                                              local_shard, placements,
                                              shard_module, use_mesh)
from repro_torch.launch.analysis import (OpCounter, active_param_count,
                                         cost_analysis_terms, model_flops,
                                         parse_collectives, roofline_terms)
from repro_torch.launch.mesh import make_production_mesh, release_mesh
from repro_torch.models.analysis_flags import card_routes
from repro_torch.models.model import model_class
from repro_torch.optim import AdamW
from repro_torch.train.step import TrainStepConfig, make_train_step


def rank0_shard(t: torch.Tensor, pls, mesh):
    """The DTensor of rank 0 holding ``t`` placed by ``pls`` on ``mesh``:
    its local shard is the first block of each sharded dim (the rules only
    shard a dim that divides), made without a collective, in a storage of
    its own (a view would carry the whole tensor's storage)."""
    from torch.distributed.tensor import DTensor
    local = t
    for pl, n in zip(pls, mesh.dims):
        if pl.is_shard():
            local = local.narrow(pl.dim, 0, local.shape[pl.dim] // n)
    return DTensor.from_local(local.clone(
        memory_format=torch.contiguous_format), mesh.device_mesh, pls,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _place(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place(v, specs[k], mesh) for k, v in tree.items()}
    return None if tree is None else rank0_shard(
        tree, placements(specs, mesh), mesh)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(tree) -> int:
    seen, total = set(), 0
    for t in _leaves(tree):
        loc = local_shard(t)
        key = loc.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += loc.untyped_storage().nbytes()
    return total


def _fake_like(meta: torch.Tensor, dev) -> torch.Tensor:
    return torch.zeros(meta.shape, dtype=meta.dtype, device=dev)


def lower_cell(cfg, shape, mesh, microbatches: int = 1):
    """Trace one (arch, shape, mesh) cell on rank 0 (``mesh``: an `LMMesh`
    of a fake process group, `mesh.make_fake_mesh`).  Returns the
    reference's result dict, plus ``state_bytes_per_device`` (the placed
    state's, or parameters', local bytes) and ``peak_tensors`` (the
    largest storages live at the peak: bytes, shape, dtype)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    dev = torch.device(mesh.device_mesh.device_type, 0)
    t0 = time.time()
    counter = OpCounter()
    with FakeTensorMode(), card_routes(), use_mesh(mesh), \
            activation_dp_over_model(cfg.dp_over_model), \
            implicit_replication():
        model = model_class(cfg)(cfg, dev)
        n_params = sum(p.numel() for p in model.parameters())
        batch_meta = model.input_specs(shape)
        if shape.kind == "train":
            opt = AdamW()
            scfg = TrainStepConfig(microbatches=microbatches)
            pspecs = SP.state_pspecs(SP.state_abstract(model, opt, scfg),
                                     mesh)
            shard_module(model, mesh, SP.to_named(pspecs["params"], mesh),
                         place=rank0_shard)
            params = dict(model.named_parameters())
            state = {"params": params, "opt": opt.init(params),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            run = make_train_step(model, opt, scfg)
            batch = _place({k: _fake_like(v, dev)
                            for k, v in batch_meta.items()},
                           SP.batch_pspecs(batch_meta, mesh), mesh)
            args = (state, batch)
            state_bytes = _local_bytes(state)
        else:
            pspecs = SP.params_pspecs(SP.params_abstract(model), mesh,
                                      serving=True)
            shard_module(model, mesh, SP.to_named(pspecs, mesh),
                         place=rank0_shard)
            state_bytes = _local_bytes(dict(model.named_parameters()))
            if shape.kind == "prefill":
                run = model.prefill
                batch = _place({k: _fake_like(v, dev)
                                for k, v in batch_meta.items()},
                               SP.batch_pspecs(batch_meta, mesh), mesh)
                args = (batch,)
            else:
                b = shape.global_batch
                cache = model.init_cache(b, shape.seq_len)
                cache = _place(cache, SP.cache_pspecs(
                    cache, mesh, batch_size=b, max_seq=shape.seq_len,
                    cfg=cfg), mesh)
                tok = _place({k: _fake_like(v, dev)
                              for k, v in batch_meta.items()},
                             SP.batch_pspecs(batch_meta, mesh),
                             mesh)["tokens"]

                def run(cache, tok):
                    return model.decode_step(cache, tok, 0)
                args = (cache, tok)
        arg_bytes = _local_bytes(args) + (0 if shape.kind == "train"
                                          else state_bytes)
        t_lower = time.time() - t0
        t0 = time.time()
        for t in _leaves(args) + [p for p in model.parameters()]:
            # a DTensor's own local tensor: ``to_local`` makes an alias
            # that would die (and untrack) at once
            counter.track(getattr(t, "_local_tensor", t))
        with counter:
            out = run(*args)
        out_bytes = _local_bytes(out)
        t_trace = time.time() - t0

    cost = cost_analysis_terms(counter)
    coll = parse_collectives(counter)
    n_chips = mesh.size
    terms = roofline_terms(cost["hlo_flops"], cost["hlo_bytes"],
                           sum(coll.values()), n_chips)
    n_active = active_param_count(cfg, n_params)
    n_tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mflops = model_flops(n_active, n_tokens,
                         "train" if shape.kind == "train" else "serve")
    return {
        "arch": cfg.arch_id, "shape": shape.name,
        "mesh": mesh.tag,
        "n_chips": n_chips,
        "n_params": n_params,
        "n_active_params": n_active,
        "microbatches": microbatches,
        "lower_s": round(t_lower, 1), "compile_s": round(t_trace, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(counter.peak - arg_bytes, 0),
            "peak_bytes_per_device": counter.peak,
        },
        "state_bytes_per_device": state_bytes,
        "peak_tensors": counter.at_peak,
        "cost": cost,
        "collective_bytes": coll,
        "collective_bytes_total": sum(coll.values()),
        "model_flops": mflops,
        # hlo_flops is per-device; global = x n_chips
        "useful_flops_ratio": (mflops / (cost["hlo_flops"] * n_chips)
                               if cost["hlo_flops"] else 0.0),
        "roofline": terms,
    }


# Per-arch gradient-accumulation defaults for train_4k (1M tokens global),
# the reference's.
TRAIN_MICROBATCHES = {
    "deepseek-v3-671b": 16, "dbrx-132b": 32, "qwen1.5-110b": 8,
    "glm4-9b": 8, "internvl2-2b": 8, "whisper-large-v3": 1,
    "internlm2-1.8b": 2, "smollm-135m": 1, "xlstm-350m": 1,
    "zamba2-2.7b": 4,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = per-arch default (train shapes)")
    args = ap.parse_args(argv)

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(arch, s) for arch in all_arch_ids()
                 for s in applicable_shapes(get_config(arch))]
    else:
        cells = [(args.arch, args.shape)]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    failures = []
    for multi_pod in pods:
        mesh = make_production_mesh(multi_pod=multi_pod)
        try:
            for arch, sname in cells:
                cfg = get_config(arch)
                shape = SHAPES[sname]
                path = outdir / f"{mesh.tag}__{arch}__{sname}.json"
                if path.exists() and not args.force:
                    print(f"[skip] {path.name} (cached)")
                    continue
                print(f"[dryrun] {arch} x {sname} on mesh {mesh.tag} ...",
                      flush=True)
                mb = 1
                if shape.kind == "train":
                    mb = args.microbatches or TRAIN_MICROBATCHES.get(arch, 1)
                try:
                    res = lower_cell(cfg, shape, mesh, microbatches=mb)
                    path.write_text(json.dumps(res, indent=1))
                    r = res["roofline"]
                    print(f"  ok: trace={res['compile_s']}s peak/dev="
                          f"{res['memory']['peak_bytes_per_device']/2**30:.2f}"
                          f"GiB flops={res['cost']['hlo_flops']:.3e} "
                          f"coll={res['collective_bytes']} "
                          f"compute={r['compute_s']:.2e}s "
                          f"mem={r['memory_s']:.2e}s "
                          f"coll={r['collective_s']:.2e}s "
                          f"dom={r['dominant']}", flush=True)
                except Exception as e:  # noqa: BLE001 -- record, continue
                    failures.append((mesh.tag, arch, sname, repr(e)))
                    print(f"  FAIL: {e!r}", flush=True)
                    traceback.print_exc()
        finally:
            release_mesh()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells traced.")


if __name__ == "__main__":
    main()
