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

A cell whose direct trace takes too long is counted from probes that
trace in a fraction of the time (`count_cell`): train cells of many
microbatches from two smaller microbatch counts, xLSTM's long sequences
from two shorter ones at smaller stacks, zamba2's train step from
smaller layer stacks.
Each route fits the model its docstring states, exactly, and equals the
direct trace on every cell it was held to (``PERF.md`` §5); the result
says how it was counted under ``counted``.  Decode's tokens are
replicated on every mesh axis, as the reference's ``in_shardings`` of
None place them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from fractions import Fraction
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
from repro_torch.train.step import (TrainStepConfig, _split_microbatches,
                                    make_train_step)


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


def _split_counts(batch, n):
    """The figures of `train.step._split_microbatches` cutting ``batch``
    into ``n`` microbatches, counted alone: FLOPs, bytes and collectives by
    kind."""
    counter = OpCounter()
    with counter:
        _split_microbatches(batch, n)
    return {"hlo_flops": counter.flops, "hlo_bytes": counter.bytes,
            "collectives": dict(counter.collectives)}


def lower_cell(cfg, shape, mesh, microbatches: int = 1, batch_like=None,
               split_at=()):
    """Trace one (arch, shape, mesh) cell on rank 0 (``mesh``: an `LMMesh`
    of a fake process group, `mesh.make_fake_mesh`).  Returns the
    reference's result dict, plus ``state_bytes_per_device`` (the placed
    state's, or parameters', local bytes) and ``peak_tensors`` (the
    largest storages live at the peak: bytes, shape, dtype).

    For the microbatch probes of `count_cell`: ``batch_like`` (a shape) is
    the cell whose batch placements the train batch takes, and
    ``split_at`` microbatch counts at which the microbatch split of a batch
    of that many microbatches is also counted alone (``split_counts``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    dev = torch.device(mesh.device_mesh.device_type, 0)
    split, inputs = {}, None
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
            specs = SP.batch_pspecs(model.input_specs(batch_like or shape),
                                    mesh)

            def train_batch(rows):
                return _place({k: _fake_like(v, dev)
                               for k, v in model.input_specs(
                                   dataclasses.replace(
                                       shape, global_batch=rows)).items()},
                              specs, mesh)
            batch = train_batch(shape.global_batch)
            mb_rows = shape.global_batch // microbatches
            for n in split_at:
                split[n] = _split_counts(train_batch(n * mb_rows), n)
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
                # replicated on every axis, as the reference's
                # in_shardings of None for the tokens and the position
                tok = rank0_shard(_fake_like(batch_meta["tokens"], dev),
                                  [Replicate()] * len(mesh.dims), mesh)

                def run(cache, tok):
                    return model.decode_step(cache, tok, 0)
                args = (cache, tok)
                inputs = {"tokens": [str(p) for p in tok.placements],
                          "pos": 0}
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
        "arch": cfg.arch_id, "shape": shape.name, "seq_len": shape.seq_len,
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
        "counted": "direct",
        "decode_inputs": inputs,
        **({"split_counts": split} if split else {}),
    }


def lagrange(xs, x):
    """The weights of the values at ``xs`` whose sum is the value at ``x``
    of the polynomial of degree len(xs) - 1 through them (exact)."""
    out = []
    for i, xi in enumerate(xs):
        w = Fraction(1)
        for j, xj in enumerate(xs):
            if j != i:
                w *= Fraction(x - xj, xi - xj)
        out.append(w)
    return out


def _sum(weights, values):
    """sum(w * v), exactly; the figures are integers, so must it be."""
    v = sum((w * Fraction(v) for w, v in zip(weights, values)), Fraction(0))
    if v.denominator != 1:
        raise ValueError(f"{values} weighted by {weights} is not integral: "
                         f"the figures do not follow the model")
    return int(v)


def _combined(probes, weights, less=None, plus=None):
    """A cell's result as a weighted sum of its probes' (`lagrange`'s
    weights, or `_by_depth`'s): every figure, the peak tensors entry by
    entry where the probes' differ (the same storages at every probe, in
    the same order), less ``less(probe, i)``'s figures before and plus
    ``plus``'s after.  Each of ``less`` and ``plus`` gives {"hlo_flops",
    "hlo_bytes", "collectives": {kind: bytes}}."""
    cost = ("hlo_flops", "hlo_bytes")

    def figures(r, i):
        f = {k: int(r["cost"][k]) for k in cost}
        f.update(("coll/" + k, v) for k, v in r["collective_bytes"].items())
        f.update(("mem/" + k, v) for k, v in r["memory"].items())
        f["state"], f["params"] = (r["state_bytes_per_device"],
                                   r["n_params"])
        if less is not None:
            sub = less(r, i)
            for k in cost:
                f[k] -= sub[k]
            for k, v in sub["collectives"].items():
                f["coll/" + k] = f.get("coll/" + k, 0) - v
        return f

    fs = [figures(r, i) for i, r in enumerate(probes)]
    keys = sorted(set().union(*fs))
    at = {k: _sum(weights, [f.get(k, 0) for f in fs]) for k in keys}
    if plus is not None:
        for k in cost:
            at[k] += plus[k]
        for k, v in plus["collectives"].items():
            at["coll/" + k] = at.get("coll/" + k, 0) + v
    ps = [r["peak_tensors"] for r in probes]
    if any(p != ps[-1] for p in ps):
        if any(len(p) != len(ps[0]) for p in ps) or any(
                e[2] != es[0][2] or len(e[1]) != len(es[0][1])
                for es in zip(*ps) for e in es):
            raise ValueError("the probes' peak tensors differ in kind")
        ps[-1] = sorted(([_sum(weights, [e[0] for e in es]),
                          [_sum(weights, ds)
                           for ds in zip(*(e[1] for e in es))],
                          es[-1][2]] for es in zip(*ps)),
                        key=lambda e: -e[0])
    res = dict(probes[-1], peak_tensors=ps[-1], n_params=at["params"],
               state_bytes_per_device=at["state"])
    res.pop("split_counts", None)
    res["cost"] = {k: float(at[k]) for k in cost}
    res["collective_bytes"] = {k[5:]: at[k] for k in keys
                               if k.startswith("coll/")}
    mem = {k[4:]: at[k] for k in keys if k.startswith("mem/")}
    mem["temp_bytes"] = max(mem["peak_bytes_per_device"]
                            - mem["argument_bytes"], 0)
    res["memory"] = {k: mem[k] for k in probes[-1]["memory"]}
    return res


def microbatch_probes(shape, mesh, microbatches: int, batch_spec):
    """The two smallest microbatch counts 2 <= m < ``microbatches`` whose
    batches of m microbatches (of the cell's size) split over the data
    axes as the cell's batch does (``batch_spec``: its leading dim's
    axes), or None."""
    axes = batch_spec if isinstance(batch_spec, tuple) else (batch_spec,)
    dp = 1
    for ax in axes:
        if ax is not None:
            dp *= mesh.shape[ax]
    rows = shape.global_batch // microbatches
    ms = [m for m in range(2, microbatches) if m * rows % dp == 0][:2]
    return tuple(ms) if len(ms) == 2 else None


def _by_microbatches(cfg, shape, mesh, n, ms):
    """The train cell at ``n`` microbatches from probes at ``ms``: the
    train step at m microbatches of the cell's size, each with the cell's
    batch placements.  A microbatch runs the same program whatever m is,
    so a probe's figures less those of its microbatch split are affine in
    m; the split (each microbatch's rows cut from the gathered batch,
    `train.step._split_microbatches`) is counted alone at m and n.  The
    peak and the argument and output bytes are affine in m as they are
    (the accumulators live from the first microbatch on)."""
    rows = shape.global_batch // n
    probes = [lower_cell(cfg, dataclasses.replace(
        shape, global_batch=m * rows), mesh, microbatches=m,
        batch_like=shape, split_at=(m, n)) for m in ms]
    split_n = probes[0]["split_counts"][n]
    if split_n != probes[1]["split_counts"][n]:
        raise ValueError("the split at n differs between the probes")
    res = _combined(probes, lagrange(ms, n),
                    less=lambda r, i: r["split_counts"][ms[i]], plus=split_n)
    res["microbatches"] = n
    res["counted"] = {
        "route": "microbatches", "probes": list(ms),
        "model": "f(m) = split(m) + a + b*m for FLOPs, bytes and each "
                 "collective kind (split(m) counted alone); a + b*m for "
                 "the peak, argument and output bytes",
        "split_at_n": split_n,
        "probe_s": [r["lower_s"] + r["compile_s"] for r in probes]}
    return _finish(res, cfg, shape, mesh)


# sequence lengths of the probes of the ``sequence`` route: multiples of
# the mLSTM's chunk (256), at least two chunks (a loop of one chunk skips
# a copy in the backward of its split)
SEQ_PROBES = (512, 768)


def _by_sequence(cfg, shape, mesh, microbatches):
    """An xLSTM train or prefill cell from probes at shorter sequences and
    smaller stacks.  The sLSTM's time loop runs S identical steps, the
    mLSTM S/256 chunks, and every other op is per token: every figure is
    affine in S, fitted exactly through two probes (a query that moves no
    bytes counts none, `analysis.OpCounter`).  The probes run at
    `_depth_variants`' depths (affine in each stack's depth), which costs
    3/4 of probes of the whole stack."""
    knobs, pts, cfgs, w_depth = _depth_variants(cfg)
    w_seq = lagrange(SEQ_PROBES, shape.seq_len)
    runs = [(c, p, a, s, b) for c, p, a in zip(cfgs, pts, w_depth) if a
            for s, b in zip(SEQ_PROBES, w_seq)]
    probes = [lower_cell(c, dataclasses.replace(shape, seq_len=s), mesh,
                         microbatches=microbatches)
              for c, _, _, s, _ in runs]
    res = _combined(probes, [a * b for _, _, a, _, b in runs])
    res["counted"] = {
        "route": "sequence", "probes": list(SEQ_PROBES), "knobs": list(knobs),
        "depths": [p for _, p, _, s, _ in runs if s == SEQ_PROBES[0]],
        "model": "f(n, S) = a(S) + n * b(S) for every figure, a and b "
                 "affine in S",
        "probe_s": [r["lower_s"] + r["compile_s"] for r in probes]}
    return _finish(res, cfg, shape, mesh)


def _finish(res, cfg, shape, mesh):
    """The derived keys of a result whose counts were extrapolated."""
    res["collective_bytes_total"] = sum(res["collective_bytes"].values())
    res["roofline"] = roofline_terms(res["cost"]["hlo_flops"],
                                     res["cost"]["hlo_bytes"],
                                     res["collective_bytes_total"],
                                     mesh.size)
    n_tokens = shape.global_batch * (1 if shape.is_decode
                                     else shape.seq_len)
    res["model_flops"] = model_flops(
        active_param_count(cfg, res["n_params"]), n_tokens,
        "train" if shape.kind == "train" else "serve")
    res["useful_flops_ratio"] = (
        res["model_flops"] / (res["cost"]["hlo_flops"] * mesh.size)
        if res["cost"]["hlo_flops"] else 0.0)
    res["shape"], res["seq_len"] = shape.name, shape.seq_len
    res["n_active_params"] = active_param_count(cfg, res["n_params"])
    probe_s = res["counted"]["probe_s"]
    res["lower_s"], res["compile_s"] = 0.0, round(sum(probe_s), 1)
    return res


# cells counted from depth probes: a train cell of few microbatches (so
# that microbatch probes would cost more than the cell) whose direct trace
# takes beyond ten minutes on a CPU
DEPTH_CELLS = {("zamba2-2.7b", "train_4k")}


def _depth_variants(cfg):
    """The depth variants of `correction.stack_knobs` (every stack one
    unit deep, then each one unit deeper): the knobs, the variants' depths
    and configs, and the weights whose sum of the variants' figures is the
    full depths' where the figures are affine in each stack's depth:
    f(full) = f(ones) + sum_i (full_i - 1) * (f(ones + e_i) - f(ones))."""
    from repro_torch.launch.correction import stack_knobs, variant_points
    knobs, full, make = stack_knobs(cfg)
    pts = variant_points(len(knobs))
    steps = [Fraction(f - 1) for f in full]
    return knobs, pts, [make(p) for p in pts], [1 - sum(steps)] + steps


def _by_depth(cfg, shape, mesh, microbatches):
    """A cell from probes at smaller layer stacks (`_depth_variants`).
    Each unit of a stack runs the same program whatever the depth, so
    every count is affine in each stack's depth; the peak is too where its
    place in the program does not move with the depth (zamba2 train_4k's
    equals its direct trace's; a reduced config's need not)."""
    knobs, pts, cfgs, weights = _depth_variants(cfg)
    probes = [lower_cell(c, shape, mesh, microbatches=microbatches)
              for c in cfgs]
    res = _combined(probes, weights)
    res["counted"] = {
        "route": "depth", "knobs": list(knobs), "probes": pts,
        "model": "f(n_1..n_k) = a + sum_i b_i * n_i for every figure",
        "probe_s": [r["lower_s"] + r["compile_s"] for r in probes]}
    return _finish(res, cfg, shape, mesh)


def route_of(cfg, shape, mesh, microbatches: int = 1):
    """The route `count_cell` takes for a cell, and its probes: the
    ``depth`` variants for a cell of `DEPTH_CELLS`; ``sequence`` for an
    xLSTM's train or prefill longer than its probes; ``microbatches``
    where probes at two smaller microbatch counts cost less than the cell;
    else ``direct``."""
    if (cfg.arch_id, shape.name) in DEPTH_CELLS:
        from repro_torch.launch.correction import stack_knobs, variant_points
        return "depth", variant_points(len(stack_knobs(cfg)[0]))
    if cfg.xlstm is not None and not shape.is_decode \
            and shape.seq_len > SEQ_PROBES[-1]:
        return "sequence", SEQ_PROBES
    ms = _microbatch_probes_of(cfg, shape, mesh, microbatches)
    if ms is not None and sum(ms) < microbatches:
        return "microbatches", ms
    return "direct", ()


def _microbatch_probes_of(cfg, shape, mesh, microbatches):
    if shape.kind != "train":
        return None
    with activation_dp_over_model(cfg.dp_over_model):
        spec = SP.batch_pspecs({"tokens": torch.empty(
            (shape.global_batch, 1), device="meta")}, mesh)["tokens"]
    return microbatch_probes(shape, mesh, microbatches, spec[0])


def count_cell(cfg, shape, mesh, microbatches: int = 1, route=None):
    """One cell's figures by ``route`` (None: `route_of`'s): ``direct``
    (`lower_cell`), ``depth`` (`_by_depth`), ``sequence`` (`_by_sequence`)
    or ``microbatches`` (`_by_microbatches`).  The result records the route
    under ``counted``."""
    if route is None:
        route = route_of(cfg, shape, mesh, microbatches)[0]
    if route == "depth":
        return _by_depth(cfg, shape, mesh, microbatches)
    if route == "sequence":
        return _by_sequence(cfg, shape, mesh, microbatches)
    if route == "microbatches":
        ms = _microbatch_probes_of(cfg, shape, mesh, microbatches)
        if ms is None:
            raise ValueError(f"{cfg.arch_id} x {shape.name}: no microbatch "
                             f"probes for {microbatches} microbatches")
        return _by_microbatches(cfg, shape, mesh, microbatches, ms)
    return lower_cell(cfg, shape, mesh, microbatches=microbatches)


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
    ap.add_argument("--route", default=None,
                    choices=("direct", "microbatches", "sequence", "depth"),
                    help="count the cell by this route (default: "
                         "`route_of`'s); the file name gains the route")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="the shape at this sequence length instead (to "
                         "hold a route to a direct trace); the file name "
                         "gains it")
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
                tag = f"{mesh.tag}__{arch}__{sname}"
                if args.seq_len:
                    shape = dataclasses.replace(shape, seq_len=args.seq_len)
                    tag += f"__s{args.seq_len}"
                if args.microbatches:
                    tag += f"__mb{args.microbatches}"
                if args.route:
                    tag += f"__{args.route}"
                path = outdir / f"{tag}.json"
                if path.exists() and not args.force:
                    print(f"[skip] {path.name} (cached)")
                    continue
                print(f"[dryrun] {arch} x {sname} on mesh {mesh.tag} ...",
                      flush=True)
                mb = 1
                if shape.kind == "train":
                    mb = args.microbatches or TRAIN_MICROBATCHES.get(arch, 1)
                try:
                    res = count_cell(cfg, shape, mesh, microbatches=mb,
                                     route=args.route)
                    path.write_text(json.dumps(res, indent=1))
                    r = res["roofline"]
                    route = (res["counted"] if res["counted"] == "direct"
                             else res["counted"]["route"])
                    print(f"  ok ({route}): trace={res['compile_s']}s "
                          f"peak/dev="
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
