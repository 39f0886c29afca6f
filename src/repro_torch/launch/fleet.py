"""DIFET fleet driver: replica pool + router replaying a synthetic
trace (`serve/trace.py`) — the multi-replica analogue of
``launch/serve.py``.  Port of ``repro/launch/fleet.py``; the replicas run
on the card unless given ``--device cpu`` (process replicas too: a
worker runs where its config says).

Open-loop injection at the trace's arrival offsets through the router:
admission control sheds (typed: tenant quota vs fleet saturation), the
consistent-hash ring routes hot scenes to their affinity replicas, and
the shared disk cache tier turns cross-replica repeats into hits.
``--proc`` spawns replicas as OS processes (`serve/proc.py`) over the
spooled-file transport.  ``--autoscale`` runs the SLO-driven autoscaler
during the replay; ``--kill-after N`` kills a replica after N accepted
requests — for process replicas that is a raw ``kill -9`` detected only
via the stale lease (chaos: the run must still complete every accepted
request, bit-identically).

    PYTHONPATH=src python -m repro_torch.launch.fleet --replicas 2 --requests 128
    PYTHONPATH=src python -m repro_torch.launch.fleet --smoke      # CI gate
    PYTHONPATH=src python -m repro_torch.launch.fleet \\
        --replicas 4 --proc --kill-after 16 --smoke          # chaos gate
    PYTHONPATH=src python -m repro_torch.launch.fleet --smoke --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import (Fleet, FleetConfig, RouterConfig, ServeConfig,
                         Shed)
from repro_torch.serve.trace import TraceConfig, make_trace, scene_key, tile_pool


def build_fleet(args) -> Fleet:
    halo = 8 if args.tile_size <= 32 else 16
    base = DifetConfig(tile=args.tile_size, halo=halo,
                       max_keypoints_per_tile=args.max_keypoints)
    serve = ServeConfig(base=base, buckets=(args.tile_size,),
                        max_batch=args.batch,
                        max_batch_delay_s=args.delay_ms * 1e-3,
                        max_pending=args.max_pending,
                        cache_entries=args.cache_entries,
                        device=args.device)
    router = RouterConfig(max_global_pending=args.max_global_pending,
                          spill_queue_threshold=args.spill_threshold,
                          tenant_rate=args.tenant_rate,
                          tenant_burst=args.tenant_burst)
    cfg = FleetConfig(serve=serve, router=router,
                      initial_replicas=args.replicas,
                      min_replicas=max(1, args.replicas // 2),
                      max_replicas=max(args.replicas, args.max_replicas),
                      warm_algorithm_sets=(("harris",),
                                           ("harris", "shi_tomasi")),
                      cache_dir=args.cache_dir
                      or tempfile.mkdtemp(prefix="difet-fleet-cache-"),
                      lease_ttl_s=args.lease_ttl,
                      proc=args.proc,
                      # proc fleets run the telemetry plane: workers ship
                      # metric deltas + spans, the parent aggregates
                      # (obs/{ship,agg,slo}.py)
                      telemetry=args.proc,
                      slo_p99_s=args.slo_ms * 1e-3)
    return Fleet(cfg)


def trace_config(args) -> TraceConfig:
    return TraceConfig(n_requests=args.requests, seed=args.seed,
                       arrival=args.arrival, rate=args.rate,
                       tile_sizes=(args.tile_size,),
                       unique_scenes=args.unique_scenes,
                       algorithm_sets=(("harris",),
                                       ("harris", "shi_tomasi")),
                       algorithm_weights=(0.7, 0.3),
                       tenants=("tenant-a", "tenant-b"),
                       tenant_weights=(0.75, 0.25))


def replay(fleet, trace, pool, kill_after=0):
    """Open-loop replay through the router.  Returns (wall, responses,
    shed_by_reason, n_killed_readmitted, accepted_events) — the last is
    index-aligned with ``responses`` (shed events are absent from both).

    ``kill_after`` kills the deepest-queued replica once that many
    requests are accepted.  Thread fleets take the eager
    ``kill_replica`` path; process fleets get a raw ``kill -9``
    (`Fleet.sigkill_replica`) and the victim is *only* discovered by the
    maintenance tick noticing the stale lease — the tick runs inline
    with the injection loop here, standing in for the background
    autoscaler thread."""
    handles, accepted, sheds = [], [], {}
    killed = False
    sigkilled = None
    readmitted = 0
    t0 = time.perf_counter()
    for i, ev in enumerate(trace):
        target = t0 + ev.t
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        try:
            handles.append(fleet.submit(pool[ev.pool_key], ev.algorithms,
                                        tenant=ev.tenant,
                                        scene_key=scene_key(ev)))
            accepted.append(ev)
        except Shed as s:
            sheds[s.reason] = sheds.get(s.reason, 0) + 1
        if kill_after and not killed and len(handles) >= kill_after:
            ready = fleet.ready_replicas()
            victim = max(ready, key=lambda n: (
                fleet.replicas[n].service.scheduler.queue_depth, n))
            if fleet.cfg.proc:
                pid = fleet.sigkill_replica(victim)
                sigkilled = victim
                print(f"[chaos] kill -9 {victim} (pid {pid}) after "
                      f"{len(handles)} accepted; awaiting stale lease")
            else:
                readmitted = fleet.kill_replica(victim)
                print(f"[chaos] killed {victim} after {len(handles)} "
                      f"accepted ({readmitted} re-admitted)")
            killed = True
        if sigkilled is not None:
            # stand-in for the autoscaler thread: detect the stale lease
            if sigkilled in fleet.maintenance_tick():
                readmitted = fleet.router.readmitted
                print(f"[chaos] stale lease detected, {sigkilled} dead "
                      f"({readmitted} re-admitted)")
                sigkilled = None
    deadline = time.perf_counter() + 30.0
    while sigkilled is not None:          # trace ended before detection
        if sigkilled in fleet.maintenance_tick():
            readmitted = fleet.router.readmitted
            print(f"[chaos] stale lease detected, {sigkilled} dead "
                  f"({readmitted} re-admitted)")
            sigkilled = None
        elif time.perf_counter() > deadline:
            raise RuntimeError(f"stale lease for {sigkilled} never "
                               f"detected within 30s")
        else:
            time.sleep(0.05)
    responses = [h.result(120) for h in handles]
    return time.perf_counter() - t0, responses, sheds, readmitted, accepted


def report(label, wall, responses, sheds, fleet):
    lat = np.asarray([r.timing["latency_s"] for r in responses])
    s = fleet.stats()
    served, shed_n = len(lat), sum(sheds.values())
    print(f"[{label}] {served} served, {shed_n} shed in {wall:.2f}s "
          f"-> {served / wall:.1f} req/s over "
          f"{s['replica_count']} replica(s)")
    if served:
        print(f"  latency p50={np.percentile(lat, 50) * 1e3:.2f} ms  "
              f"p99={np.percentile(lat, 99) * 1e3:.2f} ms")
    print(f"  routing affinity={s['routed_affinity']} "
          f"spill={s['routed_spill']} readmitted={s['readmitted']}")
    print(f"  sheds={sheds}  tenants={s['tenants']}")
    print(f"  cache hits={s['total_cache_hits']} "
          f"misses={s['total_cache_misses']}  "
          f"busy={s['total_busy_s']:.2f}s")
    for name, r in sorted(s["replicas"].items()):
        print(f"  {name}: submitted={r['submitted']} "
              f"batches={r['batches']} occ={r['batch_occupancy']:.2f} "
              f"p99q={r['p99_queue_ms']:.1f}ms state="
              f"{s['states'].get(name, '?')}")
    return s


def chaos_summary(fleet, sheds) -> None:
    """Post-run summary after a ``--kill-after`` chaos run, answered
    from the metrics registry (`obs/metrics.py`): sheds by reason,
    re-admissions, replica deaths, and the shared disk tier's hit rate
    — the 'did the fleet absorb the kill' digest.  With the telemetry
    plane on (proc fleets), the digest extends with rows only the
    *aggregated* fleet registry can answer: per-worker execution counts
    shipped from inside the worker processes, the workers' own disk-tier
    hit counters merged under ``difet.fleet.*``, and each worker
    flight-recorder dump correlated with the parent death/shed events
    recorded around it (`obs/agg.py`)."""
    m = obs_metrics.registry().snapshot()
    s = fleet.stats()
    print("chaos summary (metrics registry):")
    shed_counters = {k.rsplit(".", 1)[1]: v for k, v in m.items()
                     if k.startswith("difet.router.shed.")}
    print(f"  sheds by reason: {shed_counters or dict(sheds) or '{}'}")
    print(f"  re-admissions: {int(m.get('difet.router.readmitted', 0))}  "
          f"replicas dead: {int(m.get('difet.fleet.replicas_dead', 0))}  "
          f"stale-lease deaths: "
          f"{int(m.get('difet.fleet.stale_lease_deaths', 0))}")
    dh = m.get("difet.cache.disk_hits", 0)
    dm = m.get("difet.cache.disk_misses", 0)
    rate = dh / (dh + dm) if (dh + dm) else 0.0
    print(f"  disk tier: {int(dh)} hits / {int(dm)} misses "
          f"({rate:.1%} hit rate)")
    print(f"  outstanding after drain: {s['outstanding']}")
    agg = getattr(fleet, "telemetry", None)
    if agg is None:
        return
    fleet.poll_telemetry()                # sweep any last shipments
    m = obs_metrics.registry().snapshot()
    print("  fleet telemetry (aggregated worker shipments, "
          f"{agg.ingested} applied / {agg.dropped} dropped):")
    for w in sorted(agg.worker_counts):
        execs = agg.worker_counts[w].get("difet.scheduler.queue_s", 0)
        state = "retired" if agg.worker_final.get(w) else "live/killed"
        print(f"    {w} (pid {agg.worker_pids.get(w, 0)}, {state}): "
              f"{execs} requests executed in-worker")
    wdh = m.get("difet.fleet.cache.disk_hits", 0)
    wdm = m.get("difet.fleet.cache.disk_misses", 0)
    print(f"    worker-side disk tier: {int(wdh)} hits / {int(wdm)} "
          f"misses (from inside the worker processes)")
    for row in agg.correlate_dumps():
        kinds = sorted({str(e.get('kind')) for e in row["parent_events"]})
        print(f"    dump {row['worker']}[{row['reason']}] -> "
              f"{row['path']}  parent events nearby: {kinds or ['none']}")


def smoke(args) -> int:
    """CI smoke: short trace with a mid-trace replica kill; assert zero
    accepted-request loss, bounded shed rate, and bit-parity of *every*
    served response against a direct (unrouted) oracle service — which
    is exactly "bit-identical to a no-kill run", since the oracle never
    sees the kill.  With ``--proc`` the kill is a raw ``kill -9``
    detected via the stale lease, and the smoke additionally asserts
    the stale-lease path (not the cooperative kill) did the detection.
    Non-zero exit on failure."""
    import dataclasses

    from repro_torch.serve.api import FeatureService

    args.requests = max(32, min(args.requests, 64))
    if args.proc:
        # tight lease so stale detection lands inside the smoke window
        args.lease_ttl = min(args.lease_ttl, 1.0)
    fleet = build_fleet(args)
    tcfg = trace_config(args)
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    failures = []

    kill_after = args.kill_after or args.requests // 2
    wall, responses, sheds, readmitted, accepted = replay(
        fleet, trace, pool, kill_after=kill_after)
    served, shed_n = len(responses), sum(sheds.values())
    if served + shed_n != len(trace):
        failures.append(f"lost requests: {served} served + {shed_n} shed "
                        f"!= {len(trace)} injected")
    if served < 0.9 * len(trace):
        failures.append(f"shed rate {shed_n / len(trace):.2%} > 10%")
    if args.proc:
        m = obs_metrics.registry().snapshot()
        if int(m.get("difet.fleet.stale_lease_deaths", 0)) < 1:
            failures.append("kill -9 was not detected via the stale "
                            "lease path")

    # parity: every served response == the direct (no-kill) oracle,
    # bit-identical — accepted requests survived the kill unchanged
    oracle = FeatureService(
        dataclasses.replace(fleet.cfg.serve, cache_dir=None),
        name="smoke-oracle")
    checked = 0
    for ev, resp in zip(accepted, responses):
        want = oracle.submit(pool[ev.pool_key], resp.algorithms,
                             block=True).result(60).results
        for alg in resp.algorithms:
            for k, v in want[alg].items():
                b = resp.results[alg][k]
                if np.asarray(v).shape != b.shape \
                        or not np.array_equal(v, b):
                    failures.append(f"parity mismatch req={resp.request_id}"
                                    f" {alg}/{k}")
        checked += 1
        if checked >= 16:                 # bounded oracle cost
            break
    oracle.close()

    report("fleet-smoke", wall, responses, sheds, fleet)
    chaos_summary(fleet, sheds)
    fleet.close()
    if failures:
        print("FLEET SMOKE FAILED:", "; ".join(failures))
        return 1
    print(f"fleet smoke ok ({'proc' if args.proc else 'thread'} mode, "
          f"{served} served, {readmitted} re-admitted, "
          f"{checked} parity-checked)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--rate", type=float, default=200.0)
    ap.add_argument("--arrival", choices=("uniform", "poisson", "burst"),
                    default="burst")
    ap.add_argument("--tile-size", type=int, default=32)
    ap.add_argument("--unique-scenes", type=int, default=16)
    ap.add_argument("--max-keypoints", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--delay-ms", type=float, default=2.0)
    ap.add_argument("--max-pending", type=int, default=256)
    ap.add_argument("--max-global-pending", type=int, default=1024)
    ap.add_argument("--spill-threshold", type=int, default=16)
    ap.add_argument("--tenant-rate", type=float, default=float("inf"))
    ap.add_argument("--tenant-burst", type=float, default=64.0)
    ap.add_argument("--cache-entries", type=int, default=1024)
    ap.add_argument("--cache-dir", default=None,
                    help="shared disk cache tier (temp dir by default)")
    ap.add_argument("--lease-ttl", type=float, default=5.0)
    ap.add_argument("--proc", action="store_true",
                    help="spawn replicas as OS processes (serve/proc.py)")
    ap.add_argument("--slo-ms", type=float, default=500.0,
                    help="p99 admission-to-completion SLO for the autoscaler")
    ap.add_argument("--autoscale", action="store_true",
                    help="run the SLO-driven autoscaler during replay")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="chaos: kill one replica after N accepted requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of every replica (default: the CUDA "
                         "card; 'cpu' runs the plain twins on the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke mode: assertions + non-zero exit")
    args = ap.parse_args(argv)

    if args.smoke:
        raise SystemExit(smoke(args))

    fleet = build_fleet(args)
    if args.autoscale:
        fleet.start_autoscaler()
    tcfg = trace_config(args)
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    wall, responses, sheds, _, _ = replay(fleet, trace, pool,
                                          kill_after=args.kill_after)
    stats = report("fleet", wall, responses, sheds, fleet)
    if args.kill_after:
        chaos_summary(fleet, sheds)
    fleet.close()
    return stats


if __name__ == "__main__":
    main()
