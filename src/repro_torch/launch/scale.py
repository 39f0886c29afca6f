"""Horizontal-scaling study driver: the paper's experiment, end to end.

Port of ``repro/launch/scale.py``.  DIFET's Table 1 sweeps a fixed LandSat
scene set over 1/2/4 Hadoop nodes and reports wall-clock per algorithm.
This driver reproduces that shape on the streaming ingest: a fixed
band-striped scene set on disk, cut into fixed-shape tile batches by
`data/pipeline.py`, with the worker axis swept 1 -> N.

Worker semantics: worker *i* of *W* owns the contiguous batch slice
``batch_slices(n_batches, W)[i]`` of the restart-deterministic manifest
order; it streams only its slice (scenes outside it are never read),
staging each batch onto the device through the `Prefetcher` (pinned
memory, a copy stream), and extracts it with the same extractor.  The
workers are simulated: each worker's slice is executed and timed in turn,
and t(W) is the slowest worker (the straggler defines the makespan, as in
MapReduce).  With ``mesh=`` (`distributed/sharding.py`; ``main`` takes
``data_mesh()`` on a host with more than one card) each batch is also
split over the mesh's cards: the prefetcher stages each card's rows
straight to it, and the extractor runs each slice on its own card.

Every sweep checks bit-parity: the per-batch results of every worker count
must equal the single-worker reference array for array; scaling is a
schedule change, never a numerics change.  Runs on the CUDA card through
the kernels unless told otherwise (``--device cpu``, ``--no-use-kernels``).

    PYTHONPATH=src python -m repro_torch.launch.scale --scenes 3 \\
        --scene-size 512 --workers 1,2,4 --algorithms harris,sift \\
        --store build/difet_scale
    PYTHONPATH=src python -m repro_torch.launch.scale --smoke \\
        --store build/difet_scale
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.bundle import TileBundle
from repro_torch.core.engine import (extract_features_multi,
                                     make_distributed_multi_extractor,
                                     normalize_algorithms, resolve_device)
from repro_torch.data.landsat import (BandSceneReader,
                                      write_synthetic_scene_set)
from repro_torch.data.pipeline import (Prefetcher, batch_slices,
                                       count_batches, iter_tile_batches,
                                       pinned_empty)
from repro_torch.distributed.sharding import data_mesh, one_device


PREFETCH_DEPTH = 2   # batches in flight: double buffering


def build_scene_set(root, n_scenes: int, scene_hw: Tuple[int, int]):
    """Write (or reopen) the fixed band-striped scene set and return its
    readers in name order: the order the manifest, and therefore every
    worker count, sees."""
    root = Path(root)
    dirs = sorted(d for d in root.glob("scene_*") if d.is_dir())
    if len(dirs) < n_scenes:
        write_synthetic_scene_set(root, n_scenes, *scene_hw)
        dirs = sorted(d for d in root.glob("scene_*") if d.is_dir())
    return [BandSceneReader(d) for d in dirs[:n_scenes]]


def make_batch_extractor(algorithms, cfg: DifetConfig,
                         use_kernels: bool = True, device=None, mesh=None):
    """The per-worker batch extractor: ``fn(tiles, headers) -> {algorithm:
    result}`` over `extract_features_multi` on ``device`` (the CUDA card
    unless ``device="cpu"``), or with ``mesh`` each batch split over the
    mesh's devices (`make_distributed_multi_extractor`, results on the
    mesh's first device, the same bits; a mesh of one entry takes the
    one-device extractor on its device)."""
    mesh, device = one_device(mesh, device)
    if mesh is not None:
        return make_distributed_multi_extractor(tuple(algorithms), cfg, mesh,
                                                use_kernels)
    return functools.partial(extract_features_multi,
                             algorithms=tuple(algorithms), cfg=cfg,
                             use_kernels=use_kernels,
                             device=resolve_device(device))


def _staging(device, mesh) -> dict:
    """The prefetcher's staging target: the mesh when there is one."""
    return dict(mesh=mesh) if mesh is not None else dict(device=device)


def _alloc_for(device: torch.device):
    """Pack batches straight into pinned memory when they go to the card."""
    return pinned_empty if device.type == "cuda" else np.empty


def run_worker(readers, cfg: DifetConfig, batch_tiles: int, fn,
               lo: int, hi: int, stripe_rows: Optional[int] = None,
               prefetch_depth: int = PREFETCH_DEPTH,
               device=None, mesh=None) -> Tuple[Dict[int, Dict], float]:
    """Execute one worker's contiguous batch slice ``[lo, hi)``.

    Streams the slice through the `Prefetcher` (tiling and the copy to
    ``device``, or to each of ``mesh``'s cards its rows, overlap the
    extraction), runs ``fn`` per batch and brings each result to the host
    (``.cpu().numpy()``, which also waits for the device: the end of the
    timed window).  Returns ``({batch_index: {algorithm: {key: numpy
    array}}}, wall_seconds)``.
    """
    device = mesh[0] if mesh is not None else resolve_device(device)
    results: Dict[int, Dict] = {}
    t0 = time.perf_counter()
    with Prefetcher(iter_tile_batches(readers, cfg, batch_tiles,
                                      stripe_rows=stripe_rows,
                                      start=lo, stop=hi,
                                      alloc=_alloc_for(device)),
                    depth=prefetch_depth, device_put=True,
                    **_staging(device, mesh)) as pf:
        for idx, bundle in pf:
            out = fn(bundle.tiles, bundle.headers)
            results[idx] = {alg: {k: v.cpu().numpy() for k, v in r.items()}
                            for alg, r in out.items()}
    return results, time.perf_counter() - t0


def _warm_up(fn, cfg: DifetConfig, batch_tiles: int,
             device: torch.device, mesh=None) -> None:
    """Run ``fn`` on empty batches staged as `run_worker` stages them, as
    many as the prefetcher holds in flight: the kernels are built and
    loaded, and the pinned buffers exist, before any timed region."""
    hw = cfg.tile + 2 * cfg.halo
    alloc = _alloc_for(device)

    def empty_batches():
        for _ in range(PREFETCH_DEPTH + 2):
            tiles = alloc((batch_tiles, hw, hw), np.float32)
            headers = alloc((batch_tiles, 6), np.int32)
            tiles[:] = 0
            headers[:] = 0
            yield TileBundle(tiles, headers, cfg)

    with Prefetcher(empty_batches(), depth=PREFETCH_DEPTH, device_put=True,
                    **_staging(device, mesh)) as pf:
        for bundle in pf:
            out = fn(bundle.tiles, bundle.headers)
            for r in out.values():
                r["total_count"].cpu()


def _results_equal(a: Dict[int, Dict], b: Dict[int, Dict]) -> bool:
    """Bitwise comparison of two {batch: {alg: {key: array}}} result maps."""
    if a.keys() != b.keys():
        return False
    for idx in a:
        if a[idx].keys() != b[idx].keys():
            return False
        for alg in a[idx]:
            ra, rb = a[idx][alg], b[idx][alg]
            if ra.keys() != rb.keys():
                return False
            for k in ra:
                if not np.array_equal(np.asarray(ra[k]),
                                      np.asarray(rb[k])):
                    return False
    return True


def run_scaling(readers, cfg: DifetConfig, algorithms,
                workers: Sequence[int] = (1, 2, 4), batch_tiles: int = 8,
                use_kernels: bool = True,
                stripe_rows: Optional[int] = None, repeats: int = 1,
                device=None, mesh=None):
    """Sweep the worker count over a fixed scene set, one row per algorithm.

    For each algorithm: a warm-up on the same device and route (the first
    call on the card builds the kernel libraries), then a single-worker
    reference pass establishes t(1) and the reference per-batch results;
    each worker count W partitions the batch manifest into W contiguous
    slices, executes and times every slice, and reports the makespan t(W)
    = max over slices.  With ``repeats > 1`` every slice is executed that
    many times and its wall clock is the best of the repeats (parity is
    checked on every repeat).  Returns a list of row dicts with
    ``t``/``speedup``/``efficiency`` per worker count, the grand total
    feature count, the per-batch counts (``batch_counts``) and ``parity``
    (True iff every worker count's results were bit-identical to the
    reference's).  With ``mesh`` every batch is split over the mesh's
    devices (``device`` is then the mesh's first); a mesh of one entry runs
    the one-device sweep on its device.
    """
    algorithms = normalize_algorithms(algorithms)
    mesh, device = one_device(mesh, device)
    device = mesh[0] if mesh is not None else resolve_device(device)
    workers = tuple(workers)
    n_batches = count_batches([r.shape for r in readers], cfg, batch_tiles)
    if n_batches < max(workers):
        raise ValueError(
            f"{n_batches} batches cannot occupy {max(workers)} workers: "
            f"grow the scene set or shrink --batch-tiles")
    rows = []
    for alg in algorithms:
        fn = make_batch_extractor((alg,), cfg, use_kernels,
                                  None if mesh else device, mesh)
        _warm_up(fn, cfg, batch_tiles, device, mesh)
        times: Dict[int, float] = {}
        parity = True
        ref: Dict[int, Dict] = {}
        for w in workers:
            best_walls = None
            for _ in range(max(1, repeats)):
                worker_results: Dict[int, Dict] = {}
                walls = []
                for lo, hi in batch_slices(n_batches, w):
                    res, wall = run_worker(readers, cfg, batch_tiles, fn,
                                           lo, hi, stripe_rows,
                                           device=device, mesh=mesh)
                    worker_results.update(res)
                    walls.append(wall)
                best_walls = (walls if best_walls is None else
                              [min(a, b) for a, b in
                               zip(best_walls, walls)])
                if w == workers[0] and not ref:
                    ref = worker_results
                else:
                    parity = parity and _results_equal(ref, worker_results)
            times[w] = max(best_walls)     # straggler defines makespan
        t1 = times[workers[0]]
        batch_counts = [int(ref[i][alg]["total_count"]) for i in sorted(ref)]
        rows.append({
            "algorithm": alg, "n_batches": n_batches,
            "t": times,
            "speedup": {w: t1 / times[w] for w in workers},
            "efficiency": {w: t1 / times[w] / w for w in workers},
            "total_count": sum(batch_counts), "batch_counts": batch_counts,
            "parity": parity,
        })
    return rows


def print_table(rows, workers) -> None:
    """Render the sweep as the paper's Table-1 shape (seconds, speedup and
    efficiency)."""
    hdr = " ".join(f"t(w={w})".rjust(9) for w in workers)
    spd = " ".join(f"s(w={w})".rjust(8) for w in workers)
    eff = " ".join(f"e(w={w})".rjust(8) for w in workers)
    print(f"{'algorithm':12s} {hdr} {spd} {eff} {'count':>9s} parity")
    for r in rows:
        t = " ".join(f"{r['t'][w]:9.3f}" for w in workers)
        s = " ".join(f"{r['speedup'][w]:8.2f}" for w in workers)
        e = " ".join(f"{r['efficiency'][w]:8.2f}" for w in workers)
        print(f"{r['algorithm']:12s} {t} {s} {e} {r['total_count']:9d} "
              f"{r['parity']}")


def main(argv=None):
    """CLI entry point; ``--smoke`` is the quick gate (a tiny set, parity
    must hold for every worker count).  Returns the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--scene-size", type=int, default=512)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--halo", type=int, default=24)
    ap.add_argument("--batch-tiles", type=int, default=8)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--algorithms", default="harris,fast,sift")
    ap.add_argument("--store", required=True,
                    help="directory of the band-striped scene set (written "
                    "once, reopened after)")
    ap.add_argument("--use-kernels", action=argparse.BooleanOptionalAction,
                    default=True, help="CUDA kernels (their plain twins on "
                    "the CPU); --no-use-kernels takes the plain route")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs without the card; "
                    "'cuda' takes every card of the host, 'cuda:N' card N")
    ap.add_argument("--json", default=None,
                    help="also write the rows to this JSON path")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny mode: 2 scenes, workers 1,2; exits non-zero "
                    "unless every sweep is bit-exact")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scenes, args.scene_size = 2, 160
        args.tile, args.halo, args.batch_tiles = 64, 16, 4
        args.workers, args.algorithms = "1,2", "harris,fast"
    workers = tuple(int(w) for w in args.workers.split(","))
    try:
        algorithms = normalize_algorithms(args.algorithms)
    except ValueError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    # on a host with more than one card, --device cuda also splits the
    # batches over a data mesh of every card; --device cuda:N names one card
    # and runs the one-device sweep there
    cards = (torch.cuda.device_count() if device.type == "cuda"
             and torch.device(args.device).index is None else 0)
    mesh = data_mesh() if cards > 1 else None
    cfg = DifetConfig(tile=args.tile, halo=args.halo,
                      max_keypoints_per_tile=128)
    readers = build_scene_set(
        Path(args.store) / f"scenes_{args.scene_size}",
        args.scenes, (args.scene_size, args.scene_size))
    print(f"[scale] {len(readers)} scenes of {args.scene_size}^2, "
          f"tile={args.tile}, batch={args.batch_tiles}, "
          f"workers={workers}, algorithms={','.join(algorithms)}, "
          f"device={device}, devices={mesh.size if mesh else 1}")
    rows = run_scaling(readers, cfg, algorithms, workers,
                       batch_tiles=args.batch_tiles,
                       use_kernels=args.use_kernels,
                       device=None if mesh else device, mesh=mesh)
    print_table(rows, workers)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1, default=str))
        print(f"# wrote {args.json}")
    if not all(r["parity"] for r in rows):
        print("!! parity FAILED: some worker count changed results")
        raise SystemExit(1)
    if args.smoke:
        if not all(r["total_count"] > 0 for r in rows):
            raise SystemExit("smoke: no features extracted")
        print("[scale] smoke OK: bit-parity across worker counts, "
              f"{sum(r['total_count'] for r in rows)} features")
    return rows


if __name__ == "__main__":
    main()
