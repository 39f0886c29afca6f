"""Parent-side telemetry aggregation: merge worker shipments into
fleet-level metrics, stitch cross-process spans into one Chrome trace,
and correlate worker flight-recorder dumps with parent events.

Port of ``repro/obs/agg.py`` (host code).  The counterpart of
`obs/ship.py`.  `TelemetryAggregator.ingest`
consumes the payload dicts the workers spooled onto their mailboxes'
``telemetry/`` channels and folds them into the parent registry:

* **histograms** merge bucket-wise into ``difet.fleet.*`` names
  (``difet.scheduler.queue_s`` → ``difet.fleet.scheduler.queue_s``).
  Because every histogram in the stack shares the fixed log-spaced
  edges of `obs/metrics.py::default_bounds`, the merge is *exact*:
  the fleet histogram is indistinguishable from one that observed the
  union of all workers' streams, and its total count equals the sum of
  the per-worker observation counts (``worker_counts`` keeps that
  ledger; the ``--fleet --smoke`` CI gate asserts the equality).
* **counters** add their shipped deltas; **gauges** keep a per-worker
  last value and expose the fleet sum.
* **spans** are rebased from the worker's monotonic clock onto the
  parent's (via the shipped wall/monotonic anchor) and stamped with the
  worker's pid, so `spans_to_chrome` renders one process lane per
  worker and the admission-minted trace ids join ``admit → mailbox →
  worker exec → response`` across the process boundary.
* **dump ledgers** (worker flight-recorder artifacts) are correlated
  with the parent-side death/shed events recorded via `record_event` —
  "which worker dumped, why, and what the fleet was doing around it".
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.ship import span_from_wire
from repro_torch.obs.trace import Span

__all__ = ["fleet_metric_name", "TelemetryAggregator"]

FLEET_PREFIX = "difet.fleet."


def fleet_metric_name(name: str) -> str:
    """Worker metric name → its fleet-level aggregate name:
    ``difet.<layer>.<x>`` becomes ``difet.fleet.<layer>.<x>`` (names
    already under ``difet.fleet.`` or outside the ``difet.`` namespace
    are prefixed verbatim, so worker and parent metrics never collide in
    the parent registry)."""
    if name.startswith("difet.") and not name.startswith(FLEET_PREFIX):
        return FLEET_PREFIX + name[len("difet."):]
    return FLEET_PREFIX + name


class TelemetryAggregator:
    """Fleet-level merge of worker telemetry shipments (module
    docstring).  One instance per fleet, fed by
    `serve/fleet.py::Fleet.poll_telemetry`."""

    MAX_SPANS = 32768
    MAX_EVENTS = 512

    def __init__(self,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.registry = registry or obs_metrics.registry()
        self.spans: "deque[Span]" = deque(maxlen=self.MAX_SPANS)
        self.worker_counts: Dict[str, Dict[str, int]] = {}
        self.worker_pids: Dict[str, int] = {}
        self.worker_seq: Dict[str, int] = {}
        self.worker_final: Dict[str, bool] = {}
        self.worker_dumps: Dict[str, Dict[str, str]] = {}
        self.events: List[Dict[str, object]] = []
        self._gauge_last: Dict[str, Dict[str, float]] = {}
        self.ingested = 0
        self.dropped = 0

    # -- ingestion ------------------------------------------------------------
    def _merge_hist(self, worker: str, name: str, h: Dict[str, object]) -> None:
        fname = fleet_metric_name(name)
        bounds = tuple(h.get("bounds", ()))
        fleet = self.registry.histogram(fname, bounds or None)
        if fleet.bounds != bounds:
            self.dropped += 1       # mismatched edges: merge would lie
            return
        fleet.merge_counts(h["delta"], count=int(h.get("count", 0)),
                           sum=float(h.get("sum", 0.0)),
                           min=float(h.get("min", float("inf"))),
                           max=float(h.get("max", float("-inf"))))
        ledger = self.worker_counts.setdefault(worker, {})
        ledger[name] = ledger.get(name, 0) + int(h.get("count", 0))

    def ingest(self, payloads: Sequence[Dict[str, object]]) -> int:
        """Fold a batch of shipped telemetry payloads (as collected by
        ``WorkerMailbox.collect_telemetry``) into the fleet registry and
        span store; returns how many were applied.  Payloads replaying
        an already-seen sequence number are dropped — collection
        consumes files, but a crash between read and unlink must not
        double-count deltas."""
        applied = 0
        parent_anchor = time.time() - time.monotonic()
        for p in payloads:
            worker = str(p.get("worker", "?"))
            seq = int(p.get("seq", 0))
            if seq <= self.worker_seq.get(worker, 0):
                self.dropped += 1
                continue
            self.worker_seq[worker] = seq
            pid = int(p.get("pid", 0))
            self.worker_pids[worker] = pid
            if p.get("final"):
                self.worker_final[worker] = True
            for name, d in (p.get("counters") or {}).items():
                self.registry.counter(fleet_metric_name(name)).inc(float(d))
            for name, v in (p.get("gauges") or {}).items():
                per = self._gauge_last.setdefault(name, {})
                per[worker] = float(v)
                self.registry.gauge(fleet_metric_name(name)).set(
                    sum(per.values()))
            for name, h in (p.get("hists") or {}).items():
                self._merge_hist(worker, name, h)
            # clock rebase: worker monotonic → parent monotonic via the
            # shipped wall-clock anchor (both sides' wall clocks agree;
            # their monotonic epochs don't)
            dt = float(p.get("wall_minus_mono", parent_anchor)) \
                - parent_anchor
            for w in (p.get("spans") or ()):
                self.spans.append(span_from_wire(w, dt=dt, pid=pid))
            dumps = p.get("dumps") or {}
            if dumps:
                self.worker_dumps.setdefault(worker, {}).update(
                    {str(k): str(v) for k, v in dumps.items()})
            applied += 1
            self.ingested += 1
        return applied

    # -- correlation ----------------------------------------------------------
    def record_event(self, kind: str, **attrs) -> None:
        """Note a parent-side event worth correlating against worker
        dumps (replica death, shed storm, SLO alert).  Bounded log."""
        self.events.append({"kind": kind, "t": time.monotonic(), **attrs})
        del self.events[:-self.MAX_EVENTS]

    def correlate_dumps(self, window_s: float = 10.0) -> List[Dict[str, object]]:
        """Join each worker flight-recorder dump with the parent events
        recorded within ``window_s`` of its ingestion — the "this worker
        dumped `shed-…` right as the parent declared replica-3 dead"
        digest the chaos summary prints."""
        now = time.monotonic()
        out = []
        for worker, dumps in sorted(self.worker_dumps.items()):
            near = [e for e in self.events if now - e["t"] <= window_s]
            for reason, path in sorted(dumps.items()):
                out.append({"worker": worker, "reason": reason,
                            "path": path, "parent_events": list(near)})
        return out

    # -- stitched views -------------------------------------------------------
    def stitched_spans(self, parent_spans: Sequence[Span] = ()) -> List[Span]:
        """Parent + every worker's spans on one rebased timeline, sorted
        by start — feed to `spans_to_chrome` for the single fleet-wide
        Chrome trace with per-worker pid/tid lanes."""
        merged = list(parent_spans) + list(self.spans)
        return sorted(merged, key=lambda s: (s.t0, s.t1))

    def fleet_counts(self) -> Dict[str, int]:
        """Per-metric total observation count summed over workers — the
        ground truth the merged ``difet.fleet.*`` histogram counts must
        equal (asserted by ``launch/obs.py --fleet --smoke``)."""
        totals: Dict[str, int] = {}
        for ledger in self.worker_counts.values():
            for name, n in ledger.items():
                totals[name] = totals.get(name, 0) + n
        return totals
