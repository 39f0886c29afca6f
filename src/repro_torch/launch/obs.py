"""Observed fleet run: the `launch/fleet.py` replay with the full
observability stack switched on — flight recorder, kernel profiler, and
the two per-run artifacts (`obs/export.py`).  Port of
``repro/launch/obs.py``; the replicas run on the card unless given
``--device cpu``, and ``--profile-dir`` captures with ``torch.profiler``
(`obs/profile.py::capture`):

    PYTHONPATH=src python -m repro_torch.launch.obs --requests 64 --report \\
        --chrome-trace trace.json --metrics metrics.json
    PYTHONPATH=src python -m repro_torch.launch.obs --smoke          # CI gate
    PYTHONPATH=src python -m repro_torch.launch.obs --fleet --smoke  # CI gate

``--report`` prints the per-layer latency-breakdown table (queue /
compile / kernel / disk-tier, p50/p95/p99 from the bounded histograms);
``--chrome-trace`` writes the span timeline for ``chrome://tracing`` /
Perfetto; ``--smoke`` runs a short traced replay with a mid-trace
replica kill and exits non-zero unless the exported trace passes the
schema validator with spans from every serving layer, the re-admitted
requests' spans share their original trace id, and the flight recorder
dumped a ``replica_died`` artifact.

``--fleet --smoke`` is the telemetry-plane gate: a ``--proc`` fleet of
process replicas with a mid-replay ``kill -9``, asserting the
cross-process guarantees of `obs/{ship,agg,slo}.py` — one
schema-valid *stitched* Chrome trace with spans from >=2 distinct
worker processes, admission-minted trace ids joining parent admit spans
to worker-side exec spans (including across the kill, via readmit),
merged ``difet.fleet.*`` histogram totals exactly equal to the summed
per-worker observation counts, and a forced SLO burn-rate breach taking
exactly one deduped flight-recorder dump.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace

# every serving layer a traced fleet replay must produce spans from
REQUIRED_LAYERS = ("router", "scheduler", "batch", "kernel", "cache")


def observed_replay(args, dump_dir: str):
    """Run the `launch/fleet.py` replay with recorder + profiler
    installed; returns ``(fleet_stats, spans, flight_recorder,
    kernel_profile_snapshot)``."""
    from repro_torch.launch import fleet as fleet_mod

    rec = obs_trace.FlightRecorder(capacity=args.ring, dump_dir=dump_dir)
    prof = obs_profile.KernelProfiler()
    prev_rec = obs_trace.set_recorder(rec)
    prev_prof = obs_profile.set_profiler(prof)
    try:
        # the recorder must be live BEFORE the fleet spawns: warm-up
        # builds (graph captures on the card) are the 'compile' layer's
        # spans
        fleet = fleet_mod.build_fleet(args)
        tcfg = fleet_mod.trace_config(args)
        trace = fleet_mod.make_trace(tcfg)
        pool = fleet_mod.tile_pool(tcfg)
        with obs_profile.capture(args.profile_dir):
            wall, lat, sheds, readmitted, _accepted = fleet_mod.replay(
                fleet, trace, pool, kill_after=args.kill_after)
        stats = fleet_mod.report("obs", wall, lat, sheds, fleet)
        stats["readmitted_during_replay"] = readmitted
        spans = rec.spans()
        fleet.close()
        return stats, spans, rec, prof.snapshot()
    finally:
        obs_trace.set_recorder(prev_rec)
        obs_profile.set_profiler(prev_prof)


def smoke(args) -> int:
    """CI smoke: traced replay + chaos kill, then gate on (1) the
    exported Chrome trace passing the schema validator with >=1 span
    from every serving layer, (2) trace-id continuity across the kill
    (a ``readmit`` span sharing an admitted request's trace id), and
    (3) the flight recorder having dumped a ``replica_died`` artifact."""
    failures = []
    args.replicas = 2
    args.requests = max(32, min(args.requests, 48))
    args.kill_after = args.kill_after or args.requests // 2
    with tempfile.TemporaryDirectory(prefix="difet-obs-smoke-") as tmp:
        stats, spans, rec, prof = observed_replay(args, dump_dir=tmp)

        doc = obs_export.spans_to_chrome(spans)
        problems = obs_export.validate_chrome_trace(
            doc, required_layers=REQUIRED_LAYERS)
        failures += [f"chrome trace: {p}" for p in problems]

        readmits = [s for s in spans if s.name == "readmit"]
        if not readmits:
            failures.append("no readmit span after the chaos kill")
        admitted_tids = {s.trace_id for s in spans if s.name == "admit"}
        for s in readmits:
            if s.trace_id not in admitted_tids:
                failures.append(f"readmit span trace id {s.trace_id!r} "
                                f"matches no admitted request")
        dumps = rec.dumps
        if "replica_died" not in dumps:
            failures.append(f"flight recorder did not dump on the kill "
                            f"(dumps: {sorted(dumps)})")
        elif not os.path.exists(dumps["replica_died"]):
            failures.append("replica_died dump artifact missing on disk")

        # the metrics artifact must carry the layer breakdown the report
        # renders — queue + kernel at minimum saw traffic
        payload = obs_export.metrics_payload(
            extra={"kernel_profile": prof,
                   "fleet": {"readmitted": stats["readmitted"]}})
        stages = {r["stage"] for r in
                  obs_export.latency_breakdown(payload["metrics"])}
        for want in ("queue", "kernel"):
            if want not in stages:
                failures.append(f"breakdown table missing {want!r} stage "
                                f"(saw {sorted(stages)})")

    print(f"[obs-smoke] {len(spans)} spans, "
          f"layers={sorted({s.layer for s in spans})}, "
          f"readmit_spans={len(readmits)}")
    if failures:
        print("OBS SMOKE FAILED:", "; ".join(failures))
        return 1
    print("obs smoke ok")
    return 0


def fleet_smoke(args) -> int:
    """CI gate for the fleet telemetry plane (module docstring): a
    ``--proc`` fleet of >=2 process replicas, a mid-replay ``kill -9``
    detected via the stale lease, and a deliberately unmeetable SLO.
    Gates on:

    1. the *stitched* fleet Chrome trace (parent spans + every worker's
       shipped spans on one rebased timeline) passes the schema
       validator with spans from every serving layer and from >=2
       distinct worker processes;
    2. >=1 admission-minted trace id appears in both a parent ``admit``
       span and a worker-side ``exec`` span — and >=1 *readmitted*
       trace id re-executed worker-side, proving the id survived the
       kill across the process boundary;
    3. every merged ``difet.fleet.*`` histogram's total count equals
       the sum of the per-worker shipped observation counts (the merge
       is exact, not approximate);
    4. the forced SLO burn-rate breach alerts and takes exactly one
       deduped ``slo-burn-rate`` flight-recorder dump.
    """
    from repro_torch.launch import fleet as fleet_mod
    from repro_torch.obs import agg as obs_agg

    failures = []
    args.proc = True
    args.replicas = 2
    args.requests = max(24, min(args.requests, 32))
    args.kill_after = args.kill_after or args.requests // 2
    # tight lease so the kill -9 is declared inside the smoke window
    args.lease_ttl = min(args.lease_ttl, 1.0)
    # unmeetable SLO (1 microsecond p99): every served request burns
    # error budget, so the burn-rate monitor must alert
    args.slo_ms = 1e-3
    with tempfile.TemporaryDirectory(prefix="difet-fleet-tel-smoke-") as tmp:
        rec = obs_trace.FlightRecorder(capacity=args.ring, dump_dir=tmp)
        prev_rec = obs_trace.set_recorder(rec)
        try:
            fleet = fleet_mod.build_fleet(args)
            if fleet.telemetry is None or fleet.slo_monitor is None:
                print("FLEET TELEMETRY SMOKE FAILED: telemetry plane "
                      "not enabled on a --proc fleet")
                return 1
            tcfg = fleet_mod.trace_config(args)
            trace = fleet_mod.make_trace(tcfg)
            pool = fleet_mod.tile_pool(tcfg)
            wall, responses, sheds, readmitted, _accepted = fleet_mod.replay(
                fleet, trace, pool, kill_after=args.kill_after)
            # two monitor ticks against the microsecond SLO: the first
            # must alert + dump, the second must alert *without* a
            # second dump (dedup per reason)
            tick1 = fleet.slo_monitor.tick()
            tick2 = fleet.slo_monitor.tick()
            fleet_mod.report("fleet-telemetry-smoke", wall, responses,
                             sheds, fleet)
            fleet.close()    # drains workers -> final telemetry flushes
            fleet_mod.chaos_summary(fleet, sheds)
            agg = fleet.telemetry

            # (1) stitched cross-process trace
            stitched = agg.stitched_spans(rec.spans())
            doc = obs_export.spans_to_chrome(stitched)
            problems = obs_export.validate_chrome_trace(
                doc, required_layers=REQUIRED_LAYERS)
            failures += [f"stitched trace: {p}" for p in problems]
            worker_pids = ({s.pid for s in agg.spans}
                           - {0, os.getpid()})
            if len(worker_pids) < 2:
                failures.append(
                    f"stitched spans cover {len(worker_pids)} worker "
                    f"process(es), need >=2 (pids {sorted(worker_pids)})")

            # (2) trace-id continuity across the process boundary
            parent_spans = rec.spans()
            admit_tids = {s.trace_id for s in parent_spans
                          if s.name == "admit" and s.trace_id}
            exec_tids = {s.trace_id for s in agg.spans
                         if s.name == "exec" and s.trace_id}
            if not (admit_tids & exec_tids):
                failures.append("no trace id joins a parent admit span "
                                "to a worker-side exec span")
            readmit_tids = {s.trace_id for s in parent_spans
                            if s.name == "readmit" and s.trace_id}
            if not readmit_tids:
                failures.append("no readmit span after the chaos kill")
            elif not (readmit_tids & exec_tids):
                failures.append("no readmitted trace id re-executed "
                                "worker-side (kill survival unproven)")

            # (3) exact histogram merge: fleet totals == worker ledgers
            ledger = agg.fleet_counts()
            if not ledger:
                failures.append("no worker histograms were aggregated")
            if len(agg.worker_pids) < 2:
                failures.append(f"telemetry arrived from "
                                f"{len(agg.worker_pids)} worker(s), "
                                f"need >=2")
            reg_metrics = obs_metrics.registry().metrics()
            for name, total in sorted(ledger.items()):
                fleet_h = reg_metrics.get(obs_agg.fleet_metric_name(name))
                if fleet_h is None:
                    failures.append(f"no merged fleet histogram for "
                                    f"{name!r}")
                elif fleet_h.count != total:
                    failures.append(
                        f"fleet {name}: merged count {fleet_h.count} != "
                        f"summed per-worker counts {total}")

            # (4) forced burn-rate breach -> exactly one deduped dump
            if not tick1["alerting"]:
                failures.append(f"unmeetable SLO did not alert "
                                f"(burn_fast={tick1['burn_fast']:.2f}, "
                                f"burn_slow={tick1['burn_slow']:.2f})")
            if not tick1["dump"]:
                failures.append("first alerting tick took no "
                                "flight-recorder dump")
            if tick2["dump"]:
                failures.append("second alerting tick took a second "
                                "dump (per-reason dedup broken)")
            slo_dump = rec.dumps.get("slo-burn-rate")
            if not slo_dump:
                failures.append(f"no slo-burn-rate dump recorded "
                                f"(dumps: {sorted(rec.dumps)})")
            elif not os.path.exists(slo_dump):
                failures.append("slo-burn-rate dump artifact missing "
                                "on disk")

            print(f"[fleet-telemetry-smoke] {len(stitched)} stitched "
                  f"spans across pids {sorted(worker_pids)} + parent, "
                  f"{agg.ingested} shipments, "
                  f"{readmitted} re-admitted, "
                  f"burn_fast={tick1['burn_fast']:.1f}")
        finally:
            obs_trace.set_recorder(prev_rec)
    if failures:
        print("FLEET TELEMETRY SMOKE FAILED:", "; ".join(failures))
        return 1
    print("fleet telemetry smoke ok")
    return 0


def main(argv=None):
    """CLI: observed fleet replay (or ``--smoke``); writes the requested
    artifacts and returns the fleet stats dict."""
    ap = argparse.ArgumentParser()
    # replay knobs (mirrors launch/fleet.py)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
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
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--lease-ttl", type=float, default=5.0)
    ap.add_argument("--proc", action="store_true",
                    help="spawn replicas as OS processes (serve/proc.py)")
    ap.add_argument("--slo-ms", type=float, default=500.0,
                    help="p99 admission-to-completion SLO "
                         "(autoscaler + burn-rate monitor)")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="chaos: kill one replica after N accepted requests")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of every replica (default: the CUDA "
                         "card; 'cpu' runs the plain twins on the CPU)")
    # observability surface
    ap.add_argument("--ring", type=int, default=8192,
                    help="flight-recorder span capacity")
    ap.add_argument("--chrome-trace", default=None, metavar="OUT.json",
                    help="write the span timeline as Chrome-trace JSON")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write the flat metrics + kernel-profile JSON")
    ap.add_argument("--dump-dir", default=None,
                    help="flight-recorder crash/shed artifact directory")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler trace capture directory "
                         "(optional)")
    ap.add_argument("--report", action="store_true",
                    help="print the per-layer latency-breakdown table")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke mode: assertions + non-zero exit")
    ap.add_argument("--fleet", action="store_true",
                    help="with --smoke: the fleet telemetry-plane gate "
                         "(--proc replicas, stitched trace, SLO burn)")
    args = ap.parse_args(argv)

    if args.fleet:
        if not args.smoke:
            ap.error("--fleet requires --smoke (telemetry-plane CI gate)")
        raise SystemExit(fleet_smoke(args))
    if args.smoke:
        raise SystemExit(smoke(args))

    dump_dir = args.dump_dir or tempfile.mkdtemp(prefix="difet-obs-dumps-")
    stats, spans, rec, prof = observed_replay(args, dump_dir=dump_dir)
    payload = obs_export.metrics_payload(extra={
        "kernel_profile": prof,
        "fleet": {k: stats[k] for k in ("submitted", "readmitted", "shed",
                                        "replica_count", "total_cache_hits",
                                        "total_cache_misses")}})
    if args.chrome_trace:
        obs_export.write_chrome_trace(args.chrome_trace, spans,
                                      metadata={"requests": args.requests})
        print(f"chrome trace -> {args.chrome_trace} ({len(spans)} spans)")
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
        print(f"metrics -> {args.metrics}")
    if rec.dumps:
        for reason, path in sorted(rec.dumps.items()):
            print(f"flight-recorder dump [{reason}] -> {path}")
    if args.report:
        print(obs_export.render_report(payload))
    return stats


if __name__ == "__main__":
    main()
