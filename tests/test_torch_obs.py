"""The port's observability (``repro_torch.obs``) and the counters it
feeds: bounded-memory histograms and the registry, span tracing and the
flight recorder's Chrome dump, the kernel profiler and its
``torch.profiler`` capture, the job counters of ``core/job.py`` and the
per-bucket profile of ``kernels/ops.py::match_best2``.

The metrics and the trace are copies of the reference's plain-Python
modules: where both can answer, the port is held to ``repro.obs``'s
answer on the same observations.  Everything runs on the CPU.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.core.bundle import BundleStore, bundle_scenes
from repro_torch.core.job import DifetJob, LeaseBoard
from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.data.landsat import synthetic_scene
from repro_torch.kernels import ops
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import FlightRecorder, NoopRecorder, Span
from repro_torch.serve import FeatureService, ServeConfig

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture
def flight(tmp_path):
    """A FlightRecorder (tracing on) for the test; the process default
    (no-op) afterwards."""
    rec = FlightRecorder(capacity=4096, dump_dir=str(tmp_path))
    prev = obs_trace.set_recorder(rec)
    yield rec
    obs_trace.set_recorder(prev)


@pytest.fixture
def fresh_registry():
    """An empty registry, so counter assertions see only this test's
    traffic; the process default afterwards."""
    reg = MetricsRegistry()
    prev = obs_metrics.set_registry(reg)
    yield reg
    obs_metrics.set_registry(prev)


@pytest.fixture
def kernel_profiler():
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler())
    yield obs_profile.profiler()
    obs_profile.set_profiler(prev)


def _serve_cfg():
    return ServeConfig(base=DifetConfig(tile=32, halo=8,
                                        max_keypoints_per_tile=16),
                       buckets=(32,), max_batch=4, device="cpu")


# ---- metrics ---------------------------------------------------------------

def test_histogram_bounded_memory_under_load():
    """100k observations add no per-observation state."""
    h = Histogram("t.load")
    n_buckets = len(h._counts)
    rng = np.random.RandomState(0)
    h.observe_many(rng.lognormal(-6, 2, size=100_000).tolist())
    assert len(h._counts) == n_buckets
    assert h.count == 100_000 and sum(h._counts) == 100_000
    assert set(vars(h)) == set(vars(Histogram("t.fresh")))


@pytest.mark.parametrize("seed", [0, 7])
def test_histogram_equals_the_reference(seed):
    """The copy answers as ``repro.obs.metrics`` does: the same bucket
    counts, quantiles, mean and snapshot on the same observations."""
    vals = np.random.RandomState(seed).lognormal(-5.0, 1.5, 5000).tolist()
    ours, ref = Histogram("t.q"), jmetrics.Histogram("t.q")
    ours.observe_many(vals)
    ref.observe_many(vals)
    assert ours._counts == ref._counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    assert ours.snapshot() == ref.snapshot()
    exact = float(np.percentile(vals, 99))
    assert exact / 1.3 <= ours.quantile(0.99) <= exact * 1.3


def test_histogram_edge_cases():
    h = Histogram("t.edge")
    assert h.quantile(0.5) == 0.0
    assert h.snapshot()["count"] == 0
    h.observe(0.001)
    assert h.quantile(0.5) == pytest.approx(0.001, rel=0.3)
    h.observe(1e9)                            # overflow bucket
    assert h.count == 2 and h.max == 1e9
    with pytest.raises(ValueError):
        h.quantile(1.5)
    with pytest.raises(ValueError):
        Histogram("t.bad", bounds=(2.0, 1.0))


def test_registry_create_on_first_use_and_type_guard():
    reg = MetricsRegistry()
    c = reg.counter("difet.test.n")
    assert reg.counter("difet.test.n") is c
    c.inc()
    c.inc(2.5)
    reg.gauge("difet.test.depth").set(7)
    reg.histogram("difet.test.lat_s").observe(0.25)
    with pytest.raises(TypeError):
        reg.histogram("difet.test.n")
    snap = reg.snapshot()
    assert snap["difet.test.n"] == 3.5
    assert snap["difet.test.depth"] == 7.0
    assert snap["difet.test.lat_s"]["count"] == 1
    assert reg.names() == sorted(snap)
    reg.reset()
    assert reg.names() == []


def test_counter_gauge_thread_safety():
    c, g = Counter("c"), Gauge("g")

    def work():
        for _ in range(1000):
            c.inc()
            g.set(1.0)

    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    assert c.value == 8000.0 and g.value == 1.0


# ---- tracing ---------------------------------------------------------------

def test_noop_default_records_nothing():
    prev = obs_trace.set_recorder(NoopRecorder())
    try:
        assert not obs_trace.enabled()
        assert obs_trace.emit_span("x", "router", 0.0, 1.0) is None
        with obs_trace.span("y", "cache"):
            pass
        assert obs_trace.get_recorder().spans() == []
    finally:
        obs_trace.set_recorder(prev)


def test_flight_recorder_ring_bound_and_dump_dedupe(tmp_path):
    rec = FlightRecorder(capacity=10, dump_dir=str(tmp_path))
    prev = obs_trace.set_recorder(rec)
    try:
        for i in range(25):
            obs_trace.emit_span(f"s{i}", "router", float(i), float(i) + 0.5)
        spans = rec.spans()
        assert len(spans) == 10 and spans[0].name == "s15"
        assert rec.emitted == 25
        p1 = rec.dump_on("crash")
        assert p1 is not None and rec.dump_on("crash") is None
        doc = json.load(open(p1))
        assert doc["metadata"]["dump_reason"] == "crash"
        assert len(doc["traceEvents"]) == 10
        assert rec.dump_on("shed-other") is not None
        assert set(rec.dumps) == {"crash", "shed-other"}
    finally:
        obs_trace.set_recorder(prev)


def test_span_ids_ambient_trace_and_attrs(flight):
    tid = obs_trace.new_trace_id()
    assert obs_trace.current_trace_id() == ""
    with obs_trace.use_trace(tid):
        assert obs_trace.current_trace_id() == tid
        with obs_trace.span("disk_get", "cache", bytes=128):
            pass
    assert obs_trace.current_trace_id() == ""
    [s] = flight.spans()
    assert s.trace_id == tid and s.layer == "cache"
    assert dict(s.attrs)["bytes"] == 128 and s.duration_s >= 0.0
    sid = obs_trace.emit_span("child", "cache", 0.0, 1.0,
                              trace_id=tid, parent_id=s.span_id)
    child = flight.spans()[-1]
    assert child.parent_id == s.span_id and child.span_id == sid


def test_chrome_dump_equals_the_reference_exporter():
    """The flight recorder's Chrome document is the reference exporter's
    (``repro/obs/export.py::spans_to_chrome``) on the same spans, and
    passes its validator."""
    def spans(cls):
        return [cls(name=n, layer=layer, trace_id="t1", span_id=f"s{i}",
                    parent_id="s0" if i else "", t0=t0, t1=t1,
                    thread="main", attrs=(("bucket", 32),))
                for i, (n, layer, t0, t1) in enumerate(
                    [("queue_wait", "scheduler", 2.0, 3.0),
                     ("admit", "router", 1.0, 1.5),
                     ("device_step", "kernel", 3.0, 3.2)])]
    ours = obs_trace.spans_to_chrome(spans(Span), {"run": "t"})
    ref = jexport.spans_to_chrome(spans(jtrace.Span), {"run": "t"})
    assert ours == ref
    assert [e["name"] for e in ours["traceEvents"]] == [
        "admit", "queue_wait", "device_step"]
    assert jexport.validate_chrome_trace(
        ours, required_layers=("router", "scheduler", "kernel")) == []


def test_untraced_service_emits_no_spans():
    assert not obs_trace.enabled()
    svc = FeatureService(_serve_cfg())
    try:
        svc.warmup([("harris",)])
        svc.extract(synthetic_scene(32, 32, 1), ("harris",), timeout=60)
        assert obs_trace.get_recorder().spans() == []
    finally:
        svc.close()


def test_traced_service_spans_and_bits(flight, tmp_path):
    """A traced request leaves queue, batch, kernel and cache spans under
    its trace id, and returns the untraced service's exact bits."""
    import dataclasses
    tile = synthetic_scene(32, 32, 42)
    cfg = dataclasses.replace(_serve_cfg(), cache_dir=str(tmp_path / "t"))
    svc = FeatureService(cfg, name="rep-1")
    try:
        svc.warmup([("harris",)])
        tid = obs_trace.new_trace_id()
        traced = svc.submit(tile, ("harris",), trace_id=tid).result(60)
    finally:
        svc.close()
    spans = flight.spans()
    layers = {s.layer for s in spans if s.trace_id == tid}
    assert {"scheduler", "batch", "cache"} <= layers, layers
    assert any(s.layer == "kernel" for s in spans)
    assert any(s.name == "compile_program" for s in spans)
    obs_trace.set_recorder(NoopRecorder())
    svc = FeatureService(_serve_cfg())
    try:
        untraced = svc.extract(tile, ("harris",), timeout=60)
    finally:
        svc.close()
    for k, v in untraced.results["harris"].items():
        assert np.array_equal(v, traced.results["harris"][k]), k


def test_scheduler_quantiles_bounded_not_listy():
    svc = FeatureService(_serve_cfg())
    try:
        svc.warmup([("harris",)])
        n_buckets = len(svc.scheduler.queue_hist._counts)
        for i in range(24):
            svc.extract(synthetic_scene(32, 32, i), ("harris",), timeout=60)
        s = svc.scheduler.stats()
        assert s["items"] == 24
        assert s["p99_queue_ms"] >= s["p50_queue_ms"] >= 0.0
        assert len(svc.scheduler.queue_hist._counts) == n_buckets
        for v in vars(svc.scheduler).values():
            if isinstance(v, (list, tuple)) and len(v) > 20:
                pytest.fail(f"unbounded per-request container: {v[:3]}")
    finally:
        svc.close()


# ---- kernel profiler -------------------------------------------------------

def test_profiler_disabled_by_default_and_rows_when_on():
    assert not obs_profile.profiler().enabled
    obs_profile.record_call("match:l2:torch_full:q64k1024d32", 1.0)
    assert obs_profile.profiler().snapshot() == {}
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler())
    try:
        with obs_profile.profile_call("k1"):
            pass
        obs_profile.record_call("k1", 0.5)
        obs_profile.record_compile("k1", 2.0)
        rows = obs_profile.profiler().snapshot()
        assert rows["k1"]["calls"] == 2 and rows["k1"]["wall_s"] >= 0.5
        assert rows["k1"]["compiles"] == 1 and rows["k1"]["compile_s"] == 2.0
    finally:
        obs_profile.set_profiler(prev)
    with obs_profile.capture(None) as on:
        assert on is False


def test_capture_writes_a_chrome_trace(tmp_path):
    """``capture`` runs ``torch.profiler`` around the block and writes its
    Chrome trace under ``logdir``."""
    logdir = tmp_path / "prof"
    with obs_profile.capture(str(logdir)) as on:
        assert on is True
        torch.ones(64, 64).sum()
    [path] = list(logdir.iterdir())
    doc = json.loads(path.read_text())
    assert doc["traceEvents"]


def test_warmup_records_program_builds(kernel_profiler, fresh_registry):
    """Each program built by the service's warm-up is stamped once in
    ``difet.compile.program_s`` and in the profiler; a second warm-up
    builds nothing."""
    svc = FeatureService(_serve_cfg())
    try:
        assert svc.warmup([("harris",), ("fast", "orb")]) == 2
        assert svc.warmup([("harris",)]) == 2
    finally:
        svc.close()
    assert fresh_registry.histogram("difet.compile.program_s").count == 2
    rows = kernel_profiler.snapshot()
    assert rows["serve:32:harris"]["compiles"] == 1
    assert rows["serve:32:fast+orb"]["compiles"] == 1


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_match_best2_profiles_by_shape_bucket(kernel_profiler, metric):
    """With the profiler on, a call is stamped under its path and
    power-of-two shape bucket, and returns the unprofiled bits."""
    rng = np.random.RandomState(0)
    if metric == "l2":
        q = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
        db = torch.from_numpy(rng.randn(200, 32).astype(np.float32))
    else:
        q = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (16, 8),
                                         dtype=np.int64).astype(np.int32))
        db = torch.from_numpy(rng.randint(-2**31, 2**31 - 1, (200, 8),
                                          dtype=np.int64).astype(np.int32))
    out = ops.match_best2(q, db, metric=metric, use_kernels=False)
    rows = kernel_profiler.snapshot()
    assert list(rows) == [f"match:{metric}:torch_full:q16k256d"
                          f"{q.shape[1]}"]
    assert rows[list(rows)[0]]["calls"] == 1
    obs_profile.set_profiler(obs_profile._NoopProfiler())
    base = ops.match_best2(q, db, metric=metric, use_kernels=False)
    for a, b in zip(base, out):
        assert torch.equal(a, b)
    assert ops.shape_bucket(0, 1025, 7) == (1, 2048, 7)


# ---- job counters ----------------------------------------------------------

def test_lease_counters_acquire_refresh_and_steal(tmp_path, fresh_registry):
    board = LeaseBoard(tmp_path / "leases", ttl_s=0.0)
    assert board.acquire("a", "w1")
    assert board.acquire("a", "w1")                 # refresh: no count
    assert board.acquire("a", "w2")                 # stale at ttl 0: steal
    assert board.acquire("b", "w2")
    snap = fresh_registry.snapshot()
    assert snap["difet.job.lease_acquires"] == 2.0
    assert snap["difet.job.lease_steals"] == 1.0
    live = LeaseBoard(tmp_path / "live", ttl_s=600.0)
    assert live.acquire("c", "w1") and not live.acquire("c", "w2")
    assert fresh_registry.snapshot()["difet.job.lease_steals"] == 1.0


def test_manifest_commit_counter(tmp_path, fresh_registry):
    """A job commits its manifest once at creation and once per item."""
    cfg = DifetConfig(tile=32, halo=8, max_keypoints_per_tile=8)
    store = BundleStore(tmp_path / "store")
    for i in range(2):
        store.put(f"b{i}", bundle_scenes([synthetic_scene(64, 64, i)], cfg))
    job = DifetJob(store, "harris", shards_per_bundle=1, device="cpu")
    job.run()
    assert job.summary()["bundles_done"] == 2
    assert fresh_registry.snapshot()["difet.job.manifest_commits"] == 3.0
