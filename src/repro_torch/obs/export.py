"""Exporters: spans → Chrome-trace JSON, registry → flat metrics JSON,
plus the schema validator and the per-run latency-breakdown report.

Port of ``repro/obs/export.py``: the same documents, text for text, over
the port's registry and kernel profiler (`obs/profile.py`).

Two machine-readable artifacts per observed run:

* **Chrome trace** (``chrome://tracing`` / Perfetto ``traceEvents``
  format): every finished span becomes one complete ``"ph": "X"`` event
  — ``cat`` is the span's layer, ``ts``/``dur`` are microseconds rebased
  to trace start, ``args`` carries trace/span ids and attrs.  The
  ``tid`` is the recording thread, so replica runner threads render as
  separate rows.
* **Metrics JSON**: the flat :class:`obs/metrics.py::MetricsRegistry`
  snapshot + the kernel profiler rows, so a run's figures carry the
  provenance (the matcher's dispatch decisions: its ``dispatch:`` probe
  rows and ``difet.kernel.dispatch_measures``; cache hit mix, layer
  latency quantiles, per-program capture seconds) of the run that
  produced them.

:func:`validate_chrome_trace` is the CI smoke gate's schema check:
events well-formed, all spans closed (``dur >= 0``), timestamps
monotonic in file order, and at least one span per required layer.
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import profile as _profile

if TYPE_CHECKING:     # obs/trace.py imports this module for its dumps
    from repro_torch.obs.trace import Span

__all__ = ["spans_to_chrome", "write_chrome_trace", "metrics_payload",
           "validate_chrome_trace",
           "latency_breakdown", "render_report", "render_prometheus"]

# the per-layer latency histograms the breakdown table reports, in
# request-path order
BREAKDOWN_METRICS = (
    ("queue", "difet.scheduler.queue_s"),
    ("compile", "difet.compile.program_s"),
    ("kernel", "difet.kernel.step_s"),
    ("disk_read", "difet.cache.disk_read_s"),
    ("disk_write", "difet.cache.disk_write_s"),
)


def spans_to_chrome(spans: Sequence["Span"],
                    metadata: Optional[dict] = None) -> dict:
    """Render finished spans as a Chrome-trace document (events sorted
    by start time, timestamps rebased to the earliest span)."""
    ordered = sorted(spans, key=lambda s: (s.t0, s.t1))
    t_base = ordered[0].t0 if ordered else 0.0
    events = []
    for s in ordered:
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        args.update(dict(s.attrs))
        events.append({"name": s.name, "cat": s.layer, "ph": "X",
                       "ts": (s.t0 - t_base) * 1e6,
                       "dur": max(0.0, s.t1 - s.t0) * 1e6,
                       "pid": s.pid, "tid": s.thread, "args": args})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "metadata": {"span_count": len(events), **(metadata or {})}}
    return doc


def write_chrome_trace(path: str, spans: Sequence["Span"],
                       metadata: Optional[dict] = None) -> str:
    """Write :func:`spans_to_chrome` output to ``path``; returns it."""
    with open(path, "w") as f:
        json.dump(spans_to_chrome(spans, metadata), f, indent=1)
    return path


def metrics_payload(registry: Optional[_metrics.MetricsRegistry] = None,
                    extra: Optional[dict] = None) -> dict:
    """The metrics-JSON document: flat registry snapshot + kernel
    profiler rows (+ caller ``extra`` sections, e.g. fleet ``stats()``)."""
    reg = registry or _metrics.registry()
    doc = {"metrics": reg.snapshot(),
           "kernel_profile": _profile.profiler().snapshot()}
    if extra:
        doc.update(extra)
    return doc


def validate_chrome_trace(doc: dict,
                          required_layers: Sequence[str] = ()) -> List[str]:
    """Minimal schema check for an exported trace; returns problem
    strings (empty = valid).  Checks: ``traceEvents`` present and
    non-empty, every event carries name/cat/ph/ts/dur, every span is
    closed (``dur >= 0``) and complete (``ph == "X"``), ``ts`` is
    monotonic non-decreasing in file order, and every layer in
    ``required_layers`` contributed at least one span."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    last_ts = -1.0
    seen_layers = set()
    for i, ev in enumerate(events):
        for field in ("name", "cat", "ph", "ts", "dur"):
            if field not in ev:
                problems.append(f"event {i} missing {field!r}")
        ph, ts, dur = ev.get("ph"), ev.get("ts", -1.0), ev.get("dur", -1.0)
        if ph != "X":
            problems.append(f"event {i} ({ev.get('name')}): ph={ph!r}, "
                            f"expected complete span 'X'")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        elif ts < last_ts:
            problems.append(f"event {i}: ts {ts} < previous {last_ts} "
                            f"(not monotonic)")
        else:
            last_ts = ts
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"event {i} ({ev.get('name')}): unclosed span "
                            f"(dur={dur!r})")
        seen_layers.add(ev.get("cat"))
    for layer in required_layers:
        if layer not in seen_layers:
            problems.append(f"no spans from required layer {layer!r} "
                            f"(saw {sorted(l for l in seen_layers if l)})")
    return problems


def _prom_name(name: str) -> str:
    """Metric name → Prometheus identifier (dots and every other
    non-``[a-zA-Z0-9_]`` character become underscores)."""
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_num(v: float) -> str:
    """Render a sample value the way Prometheus text format expects
    (integers without a trailing ``.0``, floats in short form)."""
    f = float(v)
    return str(int(f)) if f == int(f) else format(f, ".10g")


def render_prometheus(
        registry: Optional[_metrics.MetricsRegistry] = None) -> str:
    """Render the registry in the Prometheus text exposition format.

    Counters and gauges become single samples; histograms expose their
    raw buckets as *cumulative* ``<name>_bucket{le="<edge>"}`` series
    (Prometheus semantics: each bucket counts every observation at or
    below its upper edge, closing with ``le="+Inf"``) plus ``_sum`` and
    ``_count``.  Bucket edges print via ``%.6g`` so the output is
    byte-stable (``tests/test_torch_telemetry.py`` holds it to the
    reference's text).  Scrape-side, ``histogram_quantile()`` over these
    buckets agrees with `Histogram.quantile` to within one bucket
    width."""
    reg = registry or _metrics.registry()
    lines: List[str] = []
    for name, m in sorted(reg.metrics().items()):
        pname = _prom_name(name)
        if isinstance(m, _metrics.Histogram):
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for edge, c in zip(m.bounds, m.counts()):
                cum += c
                lines.append(f'{pname}_bucket{{le="{edge:.6g}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {_prom_num(m.sum)}")
            lines.append(f"{pname}_count {m.count}")
        elif isinstance(m, _metrics.Gauge):
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_prom_num(m.value)}")
        else:
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_prom_num(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def latency_breakdown(metrics: Dict[str, object]) -> List[dict]:
    """Rows for the per-run latency-breakdown table from a flat metrics
    snapshot: one row per instrumented layer stage (queue / compile /
    kernel / disk tier) with count, mean and p50/p95/p99 milliseconds."""
    rows = []
    for stage, name in BREAKDOWN_METRICS:
        h = metrics.get(name)
        if not isinstance(h, dict) or not h.get("count"):
            continue
        rows.append({"stage": stage, "metric": name,
                     "count": int(h["count"]),
                     "mean_ms": h["mean"] * 1e3,
                     "p50_ms": h["p50"] * 1e3,
                     "p95_ms": h["p95"] * 1e3,
                     "p99_ms": h["p99"] * 1e3,
                     "total_s": h["sum"]})
    return rows


def render_report(payload: dict) -> str:
    """Human-readable per-run report: the latency-breakdown table plus
    headline counters, from a :func:`metrics_payload`-shaped document."""
    metrics = payload.get("metrics", {})
    lines = ["per-layer latency breakdown:"]
    rows = latency_breakdown(metrics)
    if rows:
        head = (f"  {'stage':<12}{'count':>8}{'mean ms':>10}"
                f"{'p50 ms':>10}{'p95 ms':>10}{'p99 ms':>10}{'total s':>10}")
        lines.append(head)
        lines.append("  " + "-" * (len(head) - 2))
        for r in rows:
            lines.append(f"  {r['stage']:<12}{r['count']:>8}"
                         f"{r['mean_ms']:>10.3f}{r['p50_ms']:>10.3f}"
                         f"{r['p95_ms']:>10.3f}{r['p99_ms']:>10.3f}"
                         f"{r['total_s']:>10.3f}")
    else:
        lines.append("  (no layer histograms recorded)")
    counters = {k: v for k, v in metrics.items()
                if isinstance(v, (int, float))}
    if counters:
        lines.append("counters:")
        for k in sorted(counters):
            lines.append(f"  {k} = {counters[k]:g}")
    prof = payload.get("kernel_profile") or {}
    if prof:
        lines.append("kernel profile (per dispatch bucket):")
        for key, row in prof.items():
            lines.append(f"  {key}: calls={int(row['calls'])} "
                         f"wall={row['wall_s'] * 1e3:.2f}ms "
                         f"last={row['last_wall_s'] * 1e3:.3f}ms "
                         f"compiles={int(row['compiles'])} "
                         f"compile={row['compile_s'] * 1e3:.1f}ms")
    return "\n".join(lines)
