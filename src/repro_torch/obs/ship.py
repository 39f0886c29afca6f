"""Worker-side telemetry shipping: periodic *delta* snapshots of the
process-local metrics registry plus bounded span batches, spooled onto
the ``telemetry/`` channel of the worker's mailbox
(`serve/transport.py::WorkerMailbox`).  Port of ``repro/obs/ship.py``
(host code; the wire format is the reference's).

A process replica's `MetricsRegistry` histograms and `FlightRecorder`
spans die with the process — the parent only ever saw the flat
``stats()`` dict.  The shipper closes that gap with the repo's one
trusted cross-process primitive, tmp→atomic-rename files: every
``interval_s`` it publishes one sequenced message containing

* per-**counter** value deltas and per-**gauge** current values,
* per-**histogram** bucket-count deltas (against the previous
  `Histogram.counts()` baseline) with the matching count/sum deltas and
  lifetime min/max — deltas, so the parent-side merge
  (`obs/agg.py`) is idempotent-by-sequence and *exact* under the
  shared fixed log-spaced bucket edges,
* the spans emitted since the previous shipment (bounded batch via
  `FlightRecorder.take_since`), serialized with the worker's pid and a
  wall/monotonic clock anchor so the aggregator can rebase them onto
  the parent's monotonic timeline,
* the worker's flight-recorder dump ledger (reason → artifact path),
  which the parent correlates with its own death/shed events.

One flush is forced at drain/retire (``ship(final=True)``) so a cleanly
retiring worker loses no tail telemetry; a SIGKILL'd worker loses at
most one interval's worth — the same bounded-loss contract any push
telemetry pipeline accepts.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.trace import FlightRecorder, Span

__all__ = ["span_to_wire", "span_from_wire", "TelemetryShipper"]


def span_to_wire(s: Span) -> Dict[str, object]:
    """`Span` → JSON-able dict for a telemetry shipment (attrs become a
    list of ``[key, value]`` pairs; non-JSON attr values are
    stringified)."""
    attrs = []
    for k, v in s.attrs:
        if not isinstance(v, (bool, int, float, str)) and v is not None:
            v = str(v)
        attrs.append([k, v])
    return {"name": s.name, "layer": s.layer, "trace_id": s.trace_id,
            "span_id": s.span_id, "parent_id": s.parent_id,
            "t0": s.t0, "t1": s.t1, "thread": s.thread,
            "pid": s.pid, "attrs": attrs}


def span_from_wire(d: Dict[str, object], *,
                   dt: float = 0.0, pid: Optional[int] = None) -> Span:
    """Inverse of `span_to_wire`.  ``dt`` shifts both timestamps (the
    aggregator's clock rebase onto the parent's monotonic timeline) and
    ``pid`` overrides the recorded process id when set."""
    return Span(name=str(d["name"]), layer=str(d["layer"]),
                trace_id=str(d["trace_id"]), span_id=str(d["span_id"]),
                parent_id=str(d.get("parent_id", "")),
                t0=float(d["t0"]) + dt, t1=float(d["t1"]) + dt,
                thread=str(d.get("thread", "")),
                attrs=tuple((str(k), v) for k, v in d.get("attrs", [])),
                pid=int(pid if pid is not None else d.get("pid", 0)))


class TelemetryShipper:
    """Periodic delta shipper for one worker process (module docstring).

    Construct once after the worker's service is built; baselines start
    at zero so the first shipment carries everything observed since
    process start (warm-up compiles included).  Call :meth:`maybe_ship`
    from the worker's poll loop and :meth:`ship` with ``final=True`` on
    drain."""

    def __init__(self, mailbox, worker: str, *,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 interval_s: float = 0.25, max_spans: int = 1024):
        self.mailbox = mailbox
        self.worker = worker
        self.registry = registry or obs_metrics.registry()
        self.recorder = recorder
        self.interval_s = float(interval_s)
        self.max_spans = int(max_spans)
        self.seq = 0
        self._last_ship = time.monotonic()
        self._counter_base: Dict[str, float] = {}
        self._hist_base: Dict[str, Tuple[int, ...]] = {}
        self._hist_agg_base: Dict[str, Tuple[int, float]] = {}
        self._span_cursor = 0

    # -- delta assembly -------------------------------------------------------
    def _metric_deltas(self) -> Tuple[Dict[str, float], Dict[str, float],
                                      Dict[str, Dict[str, object]]]:
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, object]] = {}
        for name, m in self.registry.metrics().items():
            if isinstance(m, obs_metrics.Histogram):
                cur = m.counts()
                base = self._hist_base.get(name, (0,) * len(cur))
                n0, s0 = self._hist_agg_base.get(name, (0, 0.0))
                delta = [c - b for c, b in zip(cur, base)]
                n1, s1 = m.count, m.sum
                if any(delta):
                    hists[name] = {
                        "bounds": list(m.bounds), "delta": delta,
                        "count": n1 - n0, "sum": s1 - s0,
                        "min": m.min, "max": m.max}
                self._hist_base[name] = cur
                self._hist_agg_base[name] = (n1, s1)
            elif isinstance(m, obs_metrics.Gauge):
                gauges[name] = m.value
            else:
                v = m.value
                d = v - self._counter_base.get(name, 0.0)
                if d:
                    counters[name] = d
                self._counter_base[name] = v
        return counters, gauges, hists

    def _span_batch(self) -> List[Dict[str, object]]:
        if self.recorder is None:
            return []
        spans, self._span_cursor = self.recorder.take_since(self._span_cursor)
        return [span_to_wire(s) for s in spans[-self.max_spans:]]

    # -- publication ----------------------------------------------------------
    def ship(self, final: bool = False) -> Optional[int]:
        """Publish one delta shipment now; returns its sequence number,
        or None when there was nothing new to ship (a ``final`` flush
        always publishes, so the parent observes the retire marker)."""
        counters, gauges, hists = self._metric_deltas()
        spans = self._span_batch()
        dumps = dict(self.recorder.dumps) if self.recorder else {}
        if not (final or counters or hists or spans):
            self._last_ship = time.monotonic()
            return None
        self.seq += 1
        meta = {"worker": self.worker, "pid": os.getpid(), "seq": self.seq,
                "final": bool(final),
                "wall_minus_mono": time.time() - time.monotonic(),
                "counters": counters, "gauges": gauges, "hists": hists,
                "spans": spans, "dumps": dumps}
        self.mailbox.publish_telemetry(self.worker, self.seq, meta)
        self._last_ship = time.monotonic()
        return self.seq

    def maybe_ship(self, now: Optional[float] = None) -> Optional[int]:
        """Ship iff ``interval_s`` has elapsed since the last attempt;
        the worker loop calls this every iteration."""
        now = time.monotonic() if now is None else now
        if now - self._last_ship < self.interval_s:
            return None
        return self.ship()
