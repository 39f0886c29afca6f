"""Depth correction for the roofline analysis (port of
``repro/launch/correction.py``).

The reference needs it because XLA's ``cost_analysis`` counts a scanned
layer stack's body once: it lowers variant configs that change each
stack's depth by one, solves the linear model

    cost(n_1..n_k) = base + sum_i n_i * per_layer_i

and extrapolates to the full depths.  The port's stacks are Python loops
and `analysis.OpCounter` counts every layer it runs, so the extrapolation
must equal the dry run's full-depth count: this module checks that the
port's counts are linear in depth.  (Each variant is counted by the dry
run's route for its cell, `dryrun.count_cell`: directly, or from
microbatch or sequence probes.)  For the same reason the port keeps
each config's ``prefill_chunks`` (the reference sets it to 1 because its
chunk loop is a ``lax.map`` counted once; a chunk's MoE capacity depends on
its token count, so the port measures the chunks it runs), and
`slstm_addon`, the reference's analytic term for the sLSTM time steps its
scan counts once, is computed and recorded but **not** added: the port's
sLSTM loop is counted step by step.

Peak memory is not corrected.  Results go back into the dry-run JSONs under
``corrected``.

    PYTHONPATH=src python -m repro_torch.launch.correction --dir build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.analysis import roofline_terms
from repro_torch.launch.mesh import make_production_mesh, release_mesh


def stack_knobs(cfg):
    """Returns (knob_names, full_counts, variant_cfg_fn): the independent
    layer-stack depths of this arch, and a config of given depths."""
    if cfg.family == "audio":
        full = (cfg.n_encoder_layers, cfg.n_layers)
        make = lambda c: cfg.replace(n_encoder_layers=c[0], n_layers=c[1])
        return ("enc", "dec"), full, make
    if cfg.moe is not None and cfg.moe.n_dense_layers:
        nd = cfg.moe.n_dense_layers
        full = (nd, cfg.n_layers - nd)
        make = lambda c: cfg.replace(
            n_layers=c[0] + c[1],
            moe=dataclasses.replace(cfg.moe, n_dense_layers=c[0]))
        return ("dense", "moe"), full, make
    if cfg.xlstm is not None:
        g = cfg.n_layers // cfg.xlstm.slstm_every
        full = (g,)
        make = lambda c: cfg.replace(n_layers=c[0] * cfg.xlstm.slstm_every)
        return ("super",), full, make
    if cfg.shared_attn_every:
        g = cfg.n_layers // cfg.shared_attn_every
        full = (g,)
        make = lambda c: cfg.replace(n_layers=c[0] * cfg.shared_attn_every)
        return ("super",), full, make
    full = (cfg.n_layers,)
    return ("layers",), full, lambda c: cfg.replace(n_layers=c[0])


def variant_points(n_knobs):
    """Probe points: all-ones plus one +1 per knob (k+1 traces)."""
    pts = [tuple([1] * n_knobs)]
    for i in range(n_knobs):
        p = [1] * n_knobs
        p[i] = 2
        pts.append(tuple(p))
    return pts


def measure(cfg, shape, mesh, microbatches: int = 1):
    """(flops, bytes, collective bytes) of one cell, counted by the dry
    run's route for it (`dryrun.count_cell`); a cell counted from depth
    variants has its variants traced directly."""
    from repro_torch.launch.dryrun import DEPTH_CELLS, count_cell
    from repro_torch.models.analysis_flags import single_chunk
    route = "direct" if (cfg.arch_id, shape.name) in DEPTH_CELLS else None
    with single_chunk():
        r = count_cell(cfg.replace(unroll_stacks=True), shape, mesh,
                       microbatches=microbatches, route=route)
    return np.array([r["cost"]["hlo_flops"], r["cost"]["hlo_bytes"],
                     r["collective_bytes_total"]], dtype=np.float64)


def slstm_addon(cfg, shape, mesh_axes_prod) -> np.ndarray:
    """The reference's analytic add-on for the (S-1) sLSTM steps its scan
    counts once: per step/device ~ 16·B_loc·d² flops (W and R matmuls,
    fwd), x3 for train (bwd); bytes ~ weight reads 32·d²·4.  Recorded, not
    added: the port counts every step."""
    if cfg.xlstm is None or shape.is_decode:
        return np.zeros(3)
    g = cfg.n_layers // cfg.xlstm.slstm_every
    d = cfg.d_model
    b_loc = max(shape.global_batch // mesh_axes_prod, 1)
    s = shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    flops = g * (s - 1) * mult * 16.0 * b_loc * d * d
    bytes_ = g * (s - 1) * mult * (32.0 * d * d)
    return np.array([flops, bytes_, 0.0])


def correct_cell(path: Path, mesh, force: bool = False, cfg=None,
                 shape=None):
    """Extrapolate one dry-run JSON's counts from depth variants traced on
    ``mesh`` (the cell's own mesh; ``cfg`` and ``shape`` default to the
    cell's arch and shape)."""
    d = json.loads(path.read_text())
    if "corrected" in d and not force:
        print(f"[skip] {path.name}")
        return d
    cfg = cfg or get_config(d["arch"])
    if shape is None:
        shape = SHAPES[d["shape"]]
        shape = dataclasses.replace(shape, seq_len=d.get("seq_len",
                                                         shape.seq_len))
    knobs, full, make = stack_knobs(cfg)
    pts = variant_points(len(knobs))
    print(f"[correct] {path.name}: knobs={knobs} full={full} "
          f"probes={pts}", flush=True)
    ys = [measure(make(p), shape, mesh, d.get("microbatches", 1))
          for p in pts]
    base_pt = np.array(pts[0], np.float64)
    y0 = ys[0]
    per_layer = np.stack([ys[i + 1] - y0 for i in range(len(knobs))])  # [k,3]
    base = y0 - base_pt @ per_layer
    fullv = np.array(full, np.float64)
    corrected = base + fullv @ per_layer
    corrected = np.maximum(corrected, y0)      # monotone guard
    dp_total = 32 if d["mesh"].count("x") == 2 else 16
    addon = slstm_addon(cfg, shape, dp_total)
    flops, hbm, coll = [float(v) for v in corrected]
    d["corrected"] = {
        "hlo_flops": flops, "hlo_bytes": hbm, "collective_bytes_total": coll,
        "per_layer": per_layer.tolist(), "base": base.tolist(),
        "knobs": list(knobs), "full": list(full),
        "slstm_addon_not_added": addon.tolist(),
        "equals_direct": [flops == d["cost"]["hlo_flops"],
                          hbm == d["cost"]["hlo_bytes"],
                          coll == float(d["collective_bytes_total"])],
        "roofline": roofline_terms(flops, hbm, coll, d["n_chips"]),
    }
    d["corrected"]["useful_flops_ratio"] = (
        d["model_flops"] / (flops * d["n_chips"]) if flops else 0.0)
    path.write_text(json.dumps(d, indent=1))
    r = d["corrected"]["roofline"]
    print(f"  corrected: compute={r['compute_s']:.3e}s "
          f"mem={r['memory_s']:.3e}s coll={r['collective_s']:.3e}s "
          f"dom={r['dominant']} frac={r['roofline_fraction']*100:.1f}% "
          f"equals direct (flops, bytes, coll)="
          f"{d['corrected']['equals_direct']}", flush=True)
    return d


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--only", default=None, help="file name prefix filter")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    files = sorted(Path(args.dir).glob("*.json"))
    if args.only:
        files = [f for f in files if f.name.startswith(args.only)]
    failures = []
    for multi_pod in (False, True):
        tag = "2x16x16" if multi_pod else "16x16"
        mine = [f for f in files if f.name.startswith(tag + "__")]
        if not mine:
            continue
        mesh = make_production_mesh(multi_pod=multi_pod)
        try:
            for f in mine:
                try:
                    d = correct_cell(f, mesh, force=args.force)
                    if not all(d["corrected"].get("equals_direct", [True])):
                        failures.append((f.name, "differs from direct"))
                except Exception as e:  # noqa: BLE001 -- record, continue
                    failures.append((f.name, repr(e)))
                    print(f"  FAIL {f.name}: {e!r}", flush=True)
        finally:
            release_mesh()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
