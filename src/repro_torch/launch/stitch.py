"""Scene-stitching entry point: extraction, pairwise registration, mosaic
layout: DIFET's second end-to-end workload, on the port.

Port of ``repro/launch/stitch.py``.  Synthetic mode cuts overlapping views
out of one wide LandSat-like scene at known offsets, so the recovered
registrations are checked against ground truth (``max_err``; sub-pixel on
integer shifts).  Both phases are checkpointed ManifestJobs: kill the
process at any point and the same command resumes.  Runs on the CUDA card
through the kernels unless told otherwise (``--device cpu``,
``--no-use-kernels``).  ``--mesh host`` (the default, as the reference's)
splits each chunk of the match phase over every card of the host
(`launch/mesh.py::make_host_mesh`; the CPU's one device with ``--device
cpu``; a host of one card registers on it as ``--mesh none`` does);
``--mesh none`` registers on ``--device`` alone, which is the only mesh
setting that takes an indexed ``--device cuda:N``.  Either gives the same
pair results.

    PYTHONPATH=src python -m repro_torch.launch.stitch --scenes 4 \\
        --scene-size 2048 --overlap 512 --tile 512 --max-keypoints 512 \\
        --algorithm orb --store build/stitch
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import mosaic
from repro_torch.core.bundle import BundleStore, bundle_scenes
from repro_torch.core.job import DifetJob
from repro_torch.data.landsat import synthetic_scene
from repro_torch.launch.mesh import make_host_mesh

DESCRIPTOR_ALGORITHMS = ("sift", "surf", "brief", "orb")


def build_overlapping_store(store_path, n_scenes: int, scene: int,
                            overlap: int, cfg: DifetConfig, seed: int = 0,
                            density: float = 4.0):
    """Synthetic overlapping scenes: crops of one wide base scene at known
    integer offsets (x strides of ``scene - overlap``, alternating y jitter
    so that the registration is 2-D).  The overlap pixels are identical
    across scenes.  Ground truth goes to ``truth.json``; the scenes and the
    offsets equal the reference's for the same arguments.  The recorded
    parameters name this package, so a store that the reference built (or
    one of other geometry) is refused rather than resumed."""
    store = BundleStore(store_path)
    truth_path = store.root / "truth.json"
    step = scene - overlap
    if step <= 0:
        raise ValueError("overlap must be smaller than scene size")
    params = {"package": "repro_torch", "n_scenes": n_scenes, "scene": scene, "overlap": overlap,
              "seed": seed, "density": density, "tile": cfg.tile,
              "max_keypoints": cfg.max_keypoints_per_tile,
              "fast_threshold": cfg.fast_threshold}
    jitter = 16
    truth = {f"scene_{i:02d}": [jitter * (i % 2), step * i]
             for i in range(n_scenes)}
    if store.list() or truth_path.exists():
        meta = json.loads(truth_path.read_text()) if truth_path.exists() \
            else {}
        if meta.get("params") != params:
            raise SystemExit(
                f"store {store.root} was built with {meta.get('params')}, "
                f"current args are {params}: pick a fresh --store (or "
                "delete the old one) instead of mixing geometries")
    else:
        # commit the build plan before any scene data, so a killed build
        # resumes (scene contents are deterministic from the params)
        truth_path.write_text(json.dumps({"params": params,
                                          "offsets": truth}))
    missing = [n for n in truth if n not in set(store.list())]
    if missing:
        base = synthetic_scene(scene + jitter,
                               scene + step * (n_scenes - 1),
                               seed, density=density)
        for name in missing:
            oy, ox = truth[name]
            store.put(name, bundle_scenes(
                [base[oy:oy + scene, ox:ox + scene]], cfg))
    return store, truth


def truth_errors(positions, truth):
    """Per-scene |estimated - true| offset, both anchored on the first
    placed scene (layout positions are relative, truth is absolute)."""
    anchor = next(iter(positions))
    errs = {}
    for name, pos in positions.items():
        true_rel = (np.asarray(truth[name], np.float64)
                    - np.asarray(truth[anchor], np.float64))
        errs[name] = float(np.abs(pos - true_rel).max())
    return errs


def main(argv=None, *, device=None):
    """Run the stitch from command-line arguments; ``device`` overrides
    ``--device``.  Returns positions, pair offsets, the mosaic summary,
    dropped pairs and ``max_err``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="orb",
                    choices=DESCRIPTOR_ALGORITHMS)
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--scene-size", type=int, default=384)
    ap.add_argument("--overlap", type=int, default=160)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--max-keypoints", type=int, default=256)
    ap.add_argument("--store", required=True,
                    help="directory of the scenes, results and manifests; "
                    "the same --store resumes")
    ap.add_argument("--ratio", type=float, default=0.8)
    ap.add_argument("--tol", type=float, default=2.0)
    ap.add_argument("--iters", type=int, default=128)
    ap.add_argument("--min-inliers", type=int, default=8)
    ap.add_argument("--pairs-per-step", type=int, default=8)
    ap.add_argument("--all-pairs", action="store_true",
                    help="register every scene pair, not just neighbours")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="CUDA kernels (their plain twins on "
                    "the CPU); --no-use-kernels takes the plain route")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without the card")
    ap.add_argument("--mesh", default="host", choices=("host", "none"),
                    help="split the match phase's pair batches over every "
                    "card of the host (the CPU with --device cpu)")
    ap.add_argument("--fail-after", type=int, default=None,
                    help="simulate worker failure after N match chunks")
    args = ap.parse_args(argv)
    device = args.device if device is None else device
    try:
        mesh = make_host_mesh(device) if args.mesh == "host" else None
    except ValueError as e:
        ap.error(f"{e}: pass --mesh none")

    # lower FAST threshold than the extraction default: registration wants
    # many verifiable corners, not just the strongest (Table-2) ones
    cfg = DifetConfig(tile=args.tile, halo=24,
                      max_keypoints_per_tile=args.max_keypoints,
                      fast_threshold=0.08)
    store, truth = build_overlapping_store(
        args.store, args.scenes, args.scene_size, args.overlap, cfg)
    scenes = store.list()
    print(f"[stitch] {args.algorithm} over {len(scenes)} scenes "
          f"({args.scene_size}^2, overlap {args.overlap}, tile {args.tile}) "
          f"on {device}")

    t0 = time.time()
    extract_job = DifetJob(store, args.algorithm,
                           use_kernels=args.use_kernels, device=device)
    extract_job.run(progress=lambda n: print(f"  extracted {n}", flush=True))

    if args.all_pairs:
        pairs = [(scenes[i], scenes[j]) for i in range(len(scenes))
                 for j in range(i + 1, len(scenes))]
    else:
        pairs = list(zip(scenes, scenes[1:]))
    phase = mosaic.MatchPhase(
        store, pairs, args.algorithm, ratio=args.ratio, tol=args.tol,
        iters=args.iters, pairs_per_step=args.pairs_per_step,
        use_kernels=args.use_kernels, device=None if mesh else device,
        mesh=mesh)
    try:
        phase.run(simulate_failure_after=args.fail_after,
                  progress=lambda n: print(f"  matched {n}", flush=True))
    except RuntimeError as e:
        print(f"  !! {e}: restart with the same command to resume")
        raise SystemExit(2)

    results = phase.results()
    for (a, b), r in results.items():
        t = np.asarray(r["t"])
        print(f"  {a} -> {b}: dy={t[0]:+7.2f} dx={t[1]:+7.2f} "
              f"inliers={int(r['n_inliers'])}/{int(r['n_matches'])} "
              f"rms={float(r['rms']):.3f}")
    positions, dropped = mosaic.solve_layout(scenes, results,
                                             args.min_inliers)
    summary = mosaic.mosaic_summary(
        positions, (args.scene_size, args.scene_size))
    dt = time.time() - t0
    print(f"[mosaic] placed {summary['n_scenes']}/{len(scenes)} scenes, "
          f"canvas {summary['mosaic_hw'][0]}x{summary['mosaic_hw'][1]}, "
          f"{len(dropped)} pair(s) dropped, {dt:.1f}s")
    max_err = None
    if truth and len(positions) > 1:
        errs = truth_errors(positions, truth)
        max_err = max(errs.values())
        print(f"[verify] max |offset error| vs ground truth: "
              f"{max_err:.3f} px")
    return {"positions": {k: (float(v[0]), float(v[1]))
                          for k, v in positions.items()},
            "pairs": {f"{a}->{b}": (float(r['t'][0]), float(r['t'][1]))
                      for (a, b), r in results.items()},
            "summary": summary, "dropped": dropped, "max_err": max_err}


if __name__ == "__main__":
    main()
