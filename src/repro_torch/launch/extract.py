"""DIFET driver: feature extraction over a bundle store, the paper's
end-to-end workload (scenes -> bundles -> map/reduce -> per-algorithm
results), checkpointed and restartable.

Port of ``repro/launch/extract.py``.  Runs on the CUDA card through the
kernels unless told otherwise (``--device cpu``, ``--no-use-kernels``);
``--store`` is required, and the same command resumes a killed run
(``--fail-after N`` kills it after N bundles and exits 2).

    PYTHONPATH=src python -m repro_torch.launch.extract --algorithm harris \\
        --scenes 3 --scene-size 768 --store build/difet_store
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core.bundle import BundleStore, bundle_scenes
from repro_torch.core.engine import normalize_algorithms, resolve_device
from repro_torch.core.job import DifetJob, SimulatedFailure
from repro_torch.data.landsat import (BandSceneReader, synthetic_scene,
                                      write_synthetic_scene_set)
from repro_torch.data.pipeline import iter_tile_batches


def build_store(store_path, n_scenes, scene_hw, cfg, scenes_per_bundle=1,
                stream: bool = False, batch_tiles: int = 64):
    """Populate (or reopen) a BundleStore with synthetic scenes.

    ``stream=False`` materializes each scene in memory (`bundle_scenes`);
    ``stream=True`` writes the scene set band-striped under
    ``<store>/scenes`` and cuts fixed-shape bundles through the streaming
    ingest (`data/pipeline.py`), one bundle per ``batch_tiles`` tiles, host
    memory bounded by the tiler's row window.  Either way the bundles equal
    the reference's for the same arguments.
    """
    store = BundleStore(store_path)
    if store.list():
        return store
    if stream:
        dirs = write_synthetic_scene_set(Path(store_path) / "scenes",
                                         n_scenes, *scene_hw)
        readers = [BandSceneReader(d) for d in dirs]
        for idx, bundle in iter_tile_batches(readers, cfg, batch_tiles):
            store.put(f"bundle_{idx:04d}", bundle)
        return store
    for i in range(0, n_scenes, scenes_per_bundle):
        scenes = [synthetic_scene(*scene_hw, seed=i + j)
                  for j in range(min(scenes_per_bundle, n_scenes - i))]
        store.put(f"bundle_{i:04d}", bundle_scenes(scenes, cfg))
    return store


def main(argv=None):
    """Run the driver from command-line arguments; returns the job's
    summary (per-algorithm grand totals in multi-algorithm mode)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithm", default="harris",
                    choices=list(PAPER_ALGORITHMS))
    ap.add_argument("--algorithms", default=None,
                    help="comma-separated multi-algorithm mode (e.g. "
                    "fast,brief,orb): one pass through "
                    "extract_features_multi, algorithms sharing a response "
                    "map compute it once per tile")
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--scene-size", type=int, default=768)
    ap.add_argument("--tile", type=int, default=256)
    ap.add_argument("--store", required=True,
                    help="directory of the bundles, results and manifest; "
                    "the same --store resumes")
    ap.add_argument("--stream", action="store_true",
                    help="build bundles through the streaming ingest "
                    "(band-striped scenes on disk, bounded host memory) "
                    "instead of in-memory scenes")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="CUDA kernels (their plain twins on "
                    "the CPU); --no-use-kernels takes the plain route")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without the card")
    ap.add_argument("--fail-after", type=int, default=None,
                    help="simulate worker failure after N bundles")
    args = ap.parse_args(argv)

    # canonicalize: strip whitespace, drop repeats (first occurrence wins),
    # reject unknown names with the valid choices listed
    try:
        algorithm = ",".join(normalize_algorithms(args.algorithms
                                                  or args.algorithm))
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    cfg = DifetConfig(tile=args.tile, halo=24, max_keypoints_per_tile=256)
    store = build_store(args.store, args.scenes,
                        (args.scene_size, args.scene_size), cfg,
                        stream=args.stream)
    job = DifetJob(store, algorithm, use_kernels=args.use_kernels,
                   device=device)
    print(f"[difet] {algorithm} over {len(store.list())} bundles "
          f"({args.scenes} scenes of {args.scene_size}^2, tile={args.tile}) "
          f"on {device}")
    t0 = time.time()
    try:
        summary = job.run(simulate_failure_after=args.fail_after,
                          progress=lambda n: print(f"  done {n}", flush=True))
    except SimulatedFailure as e:
        print(f"  !! {e}: restart with the same command to resume")
        raise SystemExit(2)
    dt = time.time() - t0
    if "per_algorithm" in summary:
        for alg, s in summary["per_algorithm"].items():
            print(f"  {alg}: {s['grand_total']} features")
    print(f"[done] {summary['bundles_done']}/{summary['bundles_total']} "
          f"bundles, {summary['grand_total']} features, {dt:.1f}s")
    return summary


if __name__ == "__main__":
    main()
