"""DIFET serving driver: in-process feature service + synthetic load
generator (the online analogue of ``launch/extract.py``'s batch job).

Port of ``repro/launch/serve.py``; the service runs on the card unless
given ``--device cpu``.  The workload itself — arrival process, hot-scene
skew, tile/algorithm mix — comes from `serve/trace.py`, the generator the
fleet's driver replays too, so single-service and fleet numbers describe
the same traffic.

Closed loop: ``--concurrency`` client threads each submit a request and
wait for it — models downstream consumers like the stitching pipeline
(arrival offsets ignored; the clients are completion-clocked).
Open loop: requests are injected at the trace's arrival offsets
regardless of completions — models public traffic; queue overflow is
load-shed (:class:`ServiceOverloaded` counted as rejected, the
backpressure knob).  ``--arrival burst`` replays Markov-modulated spikes
instead of a fixed period.

The trace cycles ``--unique-tiles`` distinct scenes over ``--requests``
requests with hot-set skew, so repeats exercise the content-hash result
cache exactly the way recurring LandSat granules would.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 96
    PYTHONPATH=src python -m repro_torch.launch.serve --mode open \
        --rate 500 --arrival burst
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import engine
from repro_torch.core.engine import normalize_algorithms
from repro_torch.serve import FeatureService, ServeConfig, ServiceOverloaded
from repro_torch.serve.trace import TraceConfig, make_trace, tile_pool


def build_service(args) -> FeatureService:
    halo = 8 if args.tile_size <= 32 else 16
    base = DifetConfig(tile=args.tile_size, halo=halo,
                       max_keypoints_per_tile=args.max_keypoints)
    cfg = ServeConfig(base=base, buckets=(args.tile_size,),
                      max_batch=args.batch,
                      max_batch_delay_s=args.delay_ms * 1e-3,
                      max_pending=args.max_pending,
                      cache_entries=args.cache_entries,
                      device=args.device)
    return FeatureService(cfg)


def trace_config(args, algs) -> TraceConfig:
    """Map the driver CLI onto one shared `serve/trace.py::TraceConfig`."""
    return TraceConfig(n_requests=args.requests, seed=args.seed,
                       arrival=args.arrival, rate=args.rate,
                       tile_sizes=(args.tile_size,),
                       unique_scenes=args.unique_tiles,
                       algorithm_sets=(tuple(algs),))


def make_pool(args):
    """Tile list for the smoke path: the trace generator's pool, indexed
    by scene (single tile size)."""
    cfg = TraceConfig(n_requests=1, seed=args.seed,
                      tile_sizes=(args.tile_size,),
                      unique_scenes=args.unique_tiles)
    tp = tile_pool(cfg)
    return [tp[(s, args.tile_size)] for s in range(args.unique_tiles)]


def run_closed(svc, trace, pool, concurrency):
    """Closed-loop: each worker submits, waits, repeats.  A failed request
    fails the run — a load generator must not mistake a dying service for
    a fast one."""
    n_requests = len(trace)
    latencies = [0.0] * n_requests
    it = iter(range(n_requests))
    lock = threading.Lock()
    errors = []

    def worker():
        while not errors:
            with lock:
                i = next(it, None)
            if i is None:
                return
            ev = trace[i]
            t0 = time.perf_counter()
            try:
                svc.submit(pool[ev.pool_key], ev.algorithms,
                           block=True).result(60)
            except Exception as e:  # noqa: BLE001 — surfaced after join
                errors.append((i, e))
                return
            latencies[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=worker)
               for _ in range(min(concurrency, n_requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        i, e = errors[0]
        raise RuntimeError(
            f"{len(errors)} request(s) failed (first: #{i}: {e!r})") from e
    return time.perf_counter() - t0, latencies, 0


def run_open(svc, trace, pool):
    """Open-loop: inject at the trace's arrival offsets; overload is
    shed, not queued.

    Latency is the service's own completion stamp
    (``timing["latency_s"]``: batch completion minus enqueue), NOT the
    handle-drain wall time — the drain loop below walks handles in submit
    order, so timing ``h.result()`` returns would add each handle's queue
    position behind its predecessors to its reported latency (at
    injection rates above service rate, that inflated every percentile
    toward the full run length)."""
    handles, rejected = [], 0
    t0 = time.perf_counter()
    for ev in trace:
        target = t0 + ev.t
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        try:
            handles.append(svc.submit(pool[ev.pool_key], ev.algorithms))
        except ServiceOverloaded:
            rejected += 1
    latencies = [h.result(60).timing["latency_s"] for h in handles]
    return time.perf_counter() - t0, latencies, rejected


def report(label, wall, latencies, rejected, svc):
    lat = np.asarray([l for l in latencies if l > 0.0])
    stats = svc.stats()
    served = len(lat)
    print(f"[{label}] {served} served, {rejected} rejected in {wall:.2f}s "
          f"-> {served / wall:.1f} req/s")
    if served:
        print(f"  latency p50={np.percentile(lat, 50) * 1e3:.2f} ms  "
              f"p99={np.percentile(lat, 99) * 1e3:.2f} ms")
    cache = stats["cache"]
    print(f"  cache hit-rate={cache['hit_rate']:.2f} "
          f"({cache['hits']} hits / {cache['misses']} misses, "
          f"{cache['entries']} entries)")
    print(f"  programs={stats['programs']} "
          f"batches={stats['scheduler']['batches']} "
          f"mean_batch={stats['scheduler']['mean_batch']:.1f} "
          f"hist={stats['scheduler']['batch_size_hist']}")
    return stats


def smoke(args) -> int:
    """CI smoke: in-process service, mixed-algorithm requests; assert
    responses, 100% cache hits on the repeat pass, and served-vs-direct
    parity (the direct side: the engine's eager ``extract_features_multi``
    on the padded tile).  Non-zero exit on any failure."""
    svc = build_service(args)
    algsets = [("harris",), ("harris", "shi_tomasi")]
    svc.warmup(algsets)
    pool = make_pool(args)
    failures = []

    # mixed-algorithm traffic
    t0 = time.perf_counter()
    handles = [svc.submit(pool[i % len(pool)], algsets[i % len(algsets)])
               for i in range(2 * len(pool))]
    resps = [h.result(60) for h in handles]
    wall = time.perf_counter() - t0
    if not all(int(r.results[a]["total_count"]) >= 0
               for r in resps for a in r.algorithms):
        failures.append("bad response payload")

    # repeat pass: every (tile, algorithm) pair must come from cache
    repeat = [svc.submit(pool[i % len(pool)], algsets[i % len(algsets)])
              .result(60) for i in range(2 * len(pool))]
    if not all(r.fully_cached for r in repeat):
        failures.append(f"repeat pass not fully cached: "
                        f"{[r.cached for r in repeat if not r.fully_cached]}")

    # parity: served == direct extract_features_multi, bit-identical
    bucket = svc.table.interiors[0]
    tile, header = svc.table.pad_to_bucket(pool[0], bucket)
    direct = engine.extract_features_multi(
        tile[None], header[None], algsets[1], svc.table.cfg_for(bucket),
        device=args.device)
    served = svc.submit(pool[0], algsets[1]).result(60).results
    for alg in algsets[1]:
        for k, v in direct[alg].items():
            a, b = v.cpu().numpy(), served[alg][k]
            if (a.shape != b.shape or a.dtype != b.dtype
                    or not np.array_equal(a, b)):
                failures.append(f"parity mismatch {alg}/{k}")

    report("smoke", wall, [r.timing["latency_s"] for r in resps], 0, svc)
    svc.close()
    if failures:
        print("SMOKE FAILED:", "; ".join(failures))
        return 1
    print("smoke ok")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--algorithms", default="harris,shi_tomasi")
    ap.add_argument("--mode", choices=("closed", "open"), default="closed")
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rate", type=float, default=500.0,
                    help="open-loop mean injection rate (req/s)")
    ap.add_argument("--arrival", choices=("uniform", "poisson", "burst"),
                    default="uniform",
                    help="open-loop arrival process (serve/trace.py)")
    ap.add_argument("--tile-size", type=int, default=32)
    ap.add_argument("--unique-tiles", type=int, default=16,
                    help="distinct scenes in the pool; repeats hit the cache")
    ap.add_argument("--max-keypoints", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--delay-ms", type=float, default=2.0)
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--cache-entries", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain twins on the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke mode: assertions + non-zero exit")
    args = ap.parse_args(argv)

    if args.smoke:
        raise SystemExit(smoke(args))

    try:
        algs = normalize_algorithms(args.algorithms)
    except ValueError as e:
        ap.error(str(e))
    svc = build_service(args)
    print(f"[serve] warmup: {svc.warmup([algs])} program(s) "
          f"(bucket {args.tile_size}, batch {args.batch})")
    tcfg = trace_config(args, algs)
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    if args.mode == "closed":
        wall, lat, rej = run_closed(svc, trace, pool, args.concurrency)
    else:
        wall, lat, rej = run_open(svc, trace, pool)
    stats = report(args.mode, wall, lat, rej, svc)
    svc.close()
    return stats


if __name__ == "__main__":
    main()
