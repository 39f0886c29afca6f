"""The port's fleet telemetry plane (``repro_torch.obs.{export,ship,agg,slo}``
and the snapshot channels of ``serve/transport.py``) against the JAX
package's, on the CPU.

Everything here is host code, so it is held bit for bit: the same inputs
give the same Prometheus text, the same span wire dicts, the same merged
histogram buckets, the same burn-rate reports and the same report text as
the reference.  The last test runs two real worker processes of the port
with the telemetry plane on and stitches their spans into one trace.
"""
import json
import os
import random
import time

import numpy as np
import pytest

from repro.obs import agg as jagg
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import ship as jship
from repro.obs import slo as jslo
from repro.obs import trace as jtrace
from repro.serve import transport as jtransport
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.agg import TelemetryAggregator, fleet_metric_name
from repro_torch.obs.export import (latency_breakdown, render_prometheus,
                                    render_report, spans_to_chrome,
                                    validate_chrome_trace)
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.ship import TelemetryShipper, span_from_wire, span_to_wire
from repro_torch.obs.slo import BurnRateMonitor, SloPolicy
from repro_torch.obs.trace import FlightRecorder, Span
from repro_torch.serve.transport import (WorkerMailbox, read_message,
                                         read_snapshot)

BOUNDS = (0.001, 0.01, 0.1, 1.0, 10.0)


@pytest.fixture
def fresh_registry():
    reg = MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    yield reg
    obs_metrics.set_registry(prev)


@pytest.fixture
def flight(tmp_path):
    (tmp_path / "dumps").mkdir(exist_ok=True)
    rec = FlightRecorder(capacity=4096, dump_dir=str(tmp_path / "dumps"))
    prev = obs_trace.set_recorder(rec)
    yield rec
    obs_trace.set_recorder(prev)


# ---- snapshot channels of the transport ------------------------------------

def test_torn_stats_file_reads_as_not_yet_without_quarantine(tmp_path):
    """A stats snapshot torn at any length reads as "not yet" and stays
    in place (the next publish overwrites it), in both packages."""
    mbox = WorkerMailbox(tmp_path / "w1")
    jmbox = jtransport.WorkerMailbox(tmp_path / "w1")
    mbox.write_stats({"submitted": 7, "name": "w1"})
    raw = (mbox.root / "stats.npz").read_bytes()
    assert jmbox.read_stats() == {"submitted": 7, "name": "w1"}
    for cut in (0, 1, 8, len(raw) // 2, len(raw) - 1):
        (mbox.root / "stats.npz").write_bytes(raw[:cut])
        assert mbox.read_stats() is None, f"cut={cut}"
        assert jmbox.read_stats() is None, f"cut={cut}"
        assert (mbox.root / "stats.npz").exists()
        assert not list(mbox.root.glob("*.corrupt"))
    mbox.write_stats({"submitted": 8, "name": "w1"})
    assert mbox.read_stats() == {"submitted": 8, "name": "w1"}


def test_torn_ready_marker_reads_as_not_yet(tmp_path):
    mbox = WorkerMailbox(tmp_path / "w1")
    mbox.write_ready({"pid": 123})
    raw = (mbox.root / "ready.npz").read_bytes()
    (mbox.root / "ready.npz").write_bytes(raw[: len(raw) // 3])
    assert mbox.read_ready() is None
    assert (mbox.root / "ready.npz").exists()
    mbox.write_ready({"pid": 123})
    assert mbox.read_ready() == {"pid": 123}


def test_queue_channel_quarantines_snapshot_channel_does_not(tmp_path):
    p = tmp_path / "r1.npz"
    p.write_bytes(b"")
    assert read_message(p) is None
    assert not p.exists() and p.with_suffix(".npz.corrupt").exists()
    p2 = tmp_path / "r2.npz"
    p2.write_bytes(b"PK\x03\x04 torn")
    assert read_snapshot(p2) is None
    assert p2.exists()


# ---- histogram mergeability -------------------------------------------------

def _merged_vs_union(values, n_shards, hist=Histogram):
    shards = [hist(f"w{i}", BOUNDS) for i in range(n_shards)]
    union = hist("union", BOUNDS)
    for i, v in enumerate(values):
        shards[i % n_shards].observe(v)
        union.observe(v)
    fleet = hist("fleet", BOUNDS)
    for sh in shards:
        fleet.merge_counts(sh.counts(), count=sh.count, sum=sh.sum,
                           min=sh.min, max=sh.max)
    return fleet, union


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7])
def test_histogram_merge_equals_union_stream(n_shards):
    """K workers' histograms merged bucket-wise are the histogram of the
    union stream, and equal the reference's merge of the same shards."""
    rng = random.Random(1234)
    values = [rng.lognormvariate(-3, 2.5) for _ in range(500)]
    fleet, union = _merged_vs_union(values, n_shards)
    jfleet, _ = _merged_vs_union(values, n_shards, jmetrics.Histogram)
    assert fleet.counts() == union.counts() == jfleet.counts()
    assert fleet.count == union.count == jfleet.count
    assert fleet.sum == jfleet.sum
    assert fleet.sum == pytest.approx(union.sum)
    assert fleet.min == union.min and fleet.max == union.max
    for q in (0.5, 0.9, 0.99):
        assert fleet.quantile(q) == jfleet.quantile(q)
        assert fleet.quantile(q) == pytest.approx(union.quantile(q))


def test_histogram_merge_rejects_mismatched_edges():
    a = Histogram("a", (0.1, 1.0))
    b = Histogram("b", (0.1, 1.0, 10.0))
    with pytest.raises(ValueError, match="merge shape mismatch"):
        a.merge_counts(b.counts())


# ---- exporters: text for text with the reference ----------------------------

def _fill(reg):
    reg.counter("difet.router.admitted").inc(41)
    reg.counter("difet.cache.disk_hits").inc(2.5)
    reg.gauge("difet.fleet.replicas_ready").set(2)
    reg.gauge("difet.scheduler.queue_depth").set(0.125)
    h = reg.histogram("difet.kernel.step_s", (0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 2.0, 99.0):
        h.observe(v)
    d = reg.histogram("difet.scheduler.queue_s")       # default edges
    rng = np.random.RandomState(5)
    for v in rng.lognormal(-5, 2, 300):
        d.observe(float(v))
    return reg


def test_render_prometheus_equals_the_reference():
    ours = render_prometheus(_fill(MetricsRegistry()))
    ref = jexport.render_prometheus(_fill(jmetrics.MetricsRegistry()))
    assert ours == ref
    assert ('difet_kernel_step_s_bucket{le="1"} 3\n'
            'difet_kernel_step_s_bucket{le="10"} 4\n'
            'difet_kernel_step_s_bucket{le="+Inf"} 5\n'
            'difet_kernel_step_s_sum 102.05\n') in ours
    assert render_prometheus(MetricsRegistry()) == ""


def test_report_and_breakdown_equal_the_reference():
    """The latency-breakdown rows and the report text of one metrics
    document, and the validator's verdicts, are the reference's."""
    snap = _fill(MetricsRegistry()).snapshot()
    for name in ("difet.compile.program_s", "difet.cache.disk_read_s"):
        snap[name] = dict(snap["difet.scheduler.queue_s"])
    payload = {"metrics": snap, "kernel_profile": {
        "serve:32:harris": {"calls": 3, "wall_s": 0.25, "last_wall_s": 0.05,
                            "compiles": 1, "compile_s": 0.125}}}
    assert latency_breakdown(snap) == jexport.latency_breakdown(snap)
    assert render_report(payload) == jexport.render_report(payload)
    good = {"traceEvents": [
        {"name": "admit", "cat": "router", "ph": "X", "ts": 0.0, "dur": 1.0},
        {"name": "exec", "cat": "batch", "ph": "X", "ts": 2.0, "dur": 0.5}]}
    bad = {"traceEvents": [
        {"name": "a", "cat": "router", "ph": "B", "ts": 5.0, "dur": -1.0},
        {"name": "b", "cat": "batch", "ts": 1.0}]}
    for doc in (good, bad, {}):
        for layers in ((), ("router", "kernel")):
            assert validate_chrome_trace(doc, layers) == \
                jexport.validate_chrome_trace(doc, layers)


# ---- span wire format -------------------------------------------------------

def _span(cls, **kw):
    return cls(name="exec", layer="batch", trace_id="t1-abc", span_id="s1",
               parent_id="b0", t0=10.0, t1=10.5, thread="runner",
               attrs=(("bucket", 32), ("ok", True), ("obj", object())),
               pid=111, **kw)


def test_span_wire_roundtrip_equals_the_reference():
    wire = span_to_wire(_span(Span))
    ref = jship.span_to_wire(_span(jtrace.Span))
    obj = [v for k, v in wire["attrs"] if k == "obj"][0]
    assert obj.startswith("<object object at")   # stringified, as ref's
    strip = lambda w: {**w, "attrs": [a for a in w["attrs"] if a[0] != "obj"]}
    assert strip(wire) == strip(ref)
    json.dumps(wire)                               # rides in npz meta
    back = span_from_wire(wire, dt=2.0, pid=222)
    jback = jship.span_from_wire(wire, dt=2.0, pid=222)
    assert (back.t0, back.t1, back.pid) == (12.0, 12.5, 222)
    for field in ("name", "layer", "trace_id", "span_id", "parent_id", "t0",
                  "t1", "thread", "attrs", "pid"):
        assert getattr(back, field) == getattr(jback, field), field
    assert dict(back.attrs)["bucket"] == 32


def test_fleet_metric_name_mapping_equals_the_reference():
    for name in ("difet.scheduler.queue_s", "difet.fleet.already",
                 "other.thing", "difet.router.shed.closed"):
        assert fleet_metric_name(name) == jagg.fleet_metric_name(name)
    assert fleet_metric_name("difet.scheduler.queue_s") \
        == "difet.fleet.scheduler.queue_s"


# ---- shipper -> aggregator --------------------------------------------------

def test_ship_and_aggregate_roundtrip(tmp_path):
    """Two shipments over a real mailbox: counter deltas accumulate,
    gauges sum per worker, histogram totals equal the per-worker ledger,
    spans arrive pid-stamped, a replayed payload is dropped — and the
    reference's mailbox and aggregator read the same shipments into the
    same registry."""
    worker_reg = MetricsRegistry()
    (tmp_path / "d").mkdir(exist_ok=True)
    rec = FlightRecorder(capacity=64, dump_dir=str(tmp_path / "d"))
    mbox = WorkerMailbox(tmp_path / "w1")
    shipper = TelemetryShipper(mbox, "w1", registry=worker_reg,
                               recorder=rec, interval_s=0.0)
    worker_reg.counter("difet.cache.disk_hits").inc(3)
    worker_reg.gauge("difet.scheduler.queue_depth").set(5)
    h = worker_reg.histogram("difet.kernel.step_s", BOUNDS)
    h.observe(0.05)
    h.observe(0.5)
    prev = obs_trace.set_recorder(rec)
    try:
        obs_trace.emit_span("exec", "batch", 1.0, 1.5, trace_id="tA")
    finally:
        obs_trace.set_recorder(prev)
    assert shipper.ship() == 1
    worker_reg.counter("difet.cache.disk_hits").inc(2)
    h.observe(7.0)
    assert shipper.ship() == 2
    assert shipper.ship() is None                        # nothing new

    payloads = jtransport.WorkerMailbox(tmp_path / "w1").collect_telemetry()
    assert [p["seq"] for p in payloads] == [1, 2]
    assert not list(mbox.tele.glob("*.npz"))             # queue drained

    parent_reg, ref_reg = MetricsRegistry(), jmetrics.MetricsRegistry()
    agg = TelemetryAggregator(parent_reg)
    jagg_ = jagg.TelemetryAggregator(ref_reg)
    assert agg.ingest(payloads) == 2 == jagg_.ingest(payloads)
    assert parent_reg.snapshot() == ref_reg.snapshot()
    assert parent_reg.counter("difet.fleet.cache.disk_hits").value == 5
    assert parent_reg.gauge("difet.fleet.scheduler.queue_depth").value == 5
    fleet_h = parent_reg.histogram("difet.fleet.kernel.step_s", BOUNDS)
    assert fleet_h.count == 3 == agg.fleet_counts()["difet.kernel.step_s"]
    assert fleet_h.counts() == h.counts()
    [span] = list(agg.spans)
    assert span.trace_id == "tA" and span.pid == os.getpid()
    assert span.t0 == pytest.approx(1.0, abs=0.05)
    assert agg.ingest(payloads) == 0 and agg.dropped == 2   # replay dropped
    assert fleet_h.count == 3
    agg.ingest([{"worker": "w2", "pid": 999, "seq": 1,
                 "wall_minus_mono": time.time() - time.monotonic(),
                 "gauges": {"difet.scheduler.queue_depth": 7.0},
                 "counters": {}, "hists": {}, "spans": [], "dumps": {}}])
    assert parent_reg.gauge("difet.fleet.scheduler.queue_depth").value == 12


def test_final_flush_always_publishes_and_carries_dumps(tmp_path):
    reg = MetricsRegistry()
    (tmp_path / "d").mkdir(exist_ok=True)
    rec = FlightRecorder(capacity=16, dump_dir=str(tmp_path / "d"))
    rec.dump_on("shed-queue_full")
    mbox = WorkerMailbox(tmp_path / "w1")
    shipper = TelemetryShipper(mbox, "w1", registry=reg, recorder=rec)
    assert shipper.ship(final=True) == 1                 # empty but final
    [p] = mbox.collect_telemetry()
    assert p["final"] is True and "shed-queue_full" in p["dumps"]
    agg = TelemetryAggregator(MetricsRegistry())
    agg.ingest([p])
    assert agg.worker_final["w1"] is True
    assert "shed-queue_full" in agg.worker_dumps["w1"]


# ---- SLO burn-rate monitor --------------------------------------------------

POLICY = dict(latency_slo_s=0.1, objective=0.9, fast_window_s=5.0,
              slow_window_s=60.0, fast_burn=2.0, slow_burn=1.5)


def _burn_run(hist_cls, monitor_cls, policy_cls, trace_mod, dump_dir):
    """The same healthy-then-cliff sequence through one package's
    monitor; returns its three reports and the recorder's dumps."""
    clock = [0.0]
    hist = hist_cls("lat", (0.01, 0.1, 1.0))
    rec = trace_mod.FlightRecorder(capacity=32, dump_dir=dump_dir)
    prev = trace_mod.set_recorder(rec)
    try:
        mon = monitor_cls(hist, policy=policy_cls(**POLICY),
                          clock=lambda: clock[0])
        reports = []
        for t, v in ((10.0, 0.005), (20.0, 0.5), (21.0, None)):
            for _ in range(50 if v is not None else 0):
                hist.observe(v)
            clock[0] = t
            reports.append(mon.tick())
        return reports, rec.dumps, mon.alerts
    finally:
        trace_mod.set_recorder(prev)


def test_burn_rate_alerts_once_with_a_deduped_dump(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours, dumps, alerts = _burn_run(Histogram, BurnRateMonitor, SloPolicy,
                                    obs_trace, str(tmp_path / "a"))
    ref, jdumps, jalerts = _burn_run(jmetrics.Histogram, jslo.BurnRateMonitor,
                                     jslo.SloPolicy, jtrace,
                                     str(tmp_path / "b"))
    healthy, cliff, still = ours
    assert not healthy["alerting"] and healthy["dump"] is None
    assert healthy["burn_fast"] == 0.0 and healthy["p99_fast"] <= 0.1
    assert cliff["alerting"] and cliff["burn_fast"] > 2.0
    assert cliff["dump"] and os.path.exists(cliff["dump"])
    assert still["alerting"] and still["dump"] is None      # deduped
    assert list(dumps) == [BurnRateMonitor.DUMP_REASON] == list(jdumps)
    assert alerts == jalerts == 2
    for a, b in zip(ours, ref):
        for key in ("burn_fast", "burn_slow", "p99_fast", "events_fast",
                    "alerting", "t"):
            assert a[key] == b[key], key


def test_burn_rate_counts_sheds_as_bad_events():
    clock = [0.0]
    hist = Histogram("lat", (0.01, 0.1, 1.0))
    shed = obs_metrics.Counter("difet.router.shed.queue_full")
    mon = BurnRateMonitor(hist, shed_counters=[shed],
                          policy=SloPolicy(**POLICY), clock=lambda: clock[0])
    for _ in range(10):
        hist.observe(0.005)
    shed.inc(90)                                       # 90% shed rate
    clock[0] = 10.0
    r = mon.tick()
    assert r["alerting"]
    assert r["burn_fast"] == pytest.approx((90 / 100) / 0.1)


# ---- the stitched trace of two worker processes -----------------------------

def test_proc_fleet_stitched_trace_two_worker_pids(tmp_path, flight,
                                                   fresh_registry,
                                                   monkeypatch):
    """Two process replicas of the port (on the CPU) with the telemetry
    plane on serve traced requests: the stitched Chrome trace validates,
    holds spans of both worker pids, an admission-minted trace id joins a
    parent admit span to a worker-side exec span, and the merged
    histogram totals equal the per-worker ledgers."""
    from repro_torch.configs.difet_paper import DifetConfig
    from repro_torch.data.landsat import synthetic_scene
    from repro_torch.serve import Fleet, FleetConfig, ServeConfig

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    base = DifetConfig(tile=32, halo=8, max_keypoints_per_tile=16)
    cfg = FleetConfig(
        serve=ServeConfig(base=base, buckets=(32,), max_batch=4,
                          max_batch_delay_s=0.005, cache_entries=64,
                          device="cpu"),
        initial_replicas=2, min_replicas=1, max_replicas=2,
        warm_algorithm_sets=(("harris",),),
        cache_dir=str(tmp_path / "cache"),
        lease_dir=str(tmp_path / "leases"),
        transport_dir=str(tmp_path / "mbox"),
        proc=True, lease_ttl_s=30.0, heartbeat_interval_s=0.1,
        telemetry=True, telemetry_interval_s=0.05)
    fleet = Fleet(cfg)
    try:
        assert fleet.telemetry is not None
        tiles = [synthetic_scene(32, 32, 900 + i) for i in range(8)]
        handles = [fleet.submit(t, ("harris",), scene_key=f"sc-{i}")
                   for i, t in enumerate(tiles)]
        for h in handles:
            h.result(120)
    finally:
        fleet.close()          # drains -> final flush -> last poll
    agg = fleet.telemetry
    worker_pids = {s.pid for s in agg.spans} - {0, os.getpid()}
    assert len(worker_pids) == 2, f"worker pids seen: {worker_pids}"
    assert set(agg.worker_final.values()) == {True}
    stitched = agg.stitched_spans(flight.spans())
    doc = spans_to_chrome(stitched)
    assert validate_chrome_trace(
        doc, required_layers=("router", "scheduler", "batch")) == []
    assert jexport.validate_chrome_trace(doc, ("router", "batch")) == []
    admit = {s.trace_id for s in flight.spans()
             if s.name == "admit" and s.trace_id}
    execs = {s.trace_id for s in agg.spans
             if s.name == "exec" and s.trace_id}
    assert len(admit) == 8 and admit <= execs
    reg = obs_metrics.registry().metrics()
    ledger = agg.fleet_counts()
    assert ledger["difet.scheduler.queue_s"] == 8
    for name, total in ledger.items():
        assert reg[fleet_metric_name(name)].count == total, name
