"""Structured span tracing: request-scoped timelines across every layer
of the serving stack, recorded into a bounded flight recorder.

A *span* is one timed operation (``queue_wait``, ``device_step``,
``disk_get``, ``readmit``, …) tagged with the **trace id** minted when
its request passed router admission — so one request's whole journey
(admission → replica queue → batch execution → cache tiers → possibly a
``readmit`` hop after ``ReplicaDied``) shares one id and renders as one
lane in ``chrome://tracing`` (`obs/export.py`).

The recorder is process-global and defaults to :class:`NoopRecorder`:
every instrumentation site guards on ``enabled()`` before touching a
clock, so the disabled cost is one attribute read per site — so an
untraced service pays nothing measurable for the instrumentation.  :class:`FlightRecorder` keeps the last N
finished spans in a ring buffer and can dump them as Chrome-trace JSON
on demand or on a crash/shed trigger (``dump_on``) — the "what was the
fleet doing right before it died" artifact.

Timestamps are ``time.monotonic()`` floats; cross-thread ordering within
a process is meaningful (Linux CLOCK_MONOTONIC), and the exporter
rebases to trace start.  Instrumentation only *observes* — it never
changes batch formation, routing, or numerics, so traced runs stay
bit-identical to untraced ones (tested).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.obs.export import (spans_to_chrome,  # noqa: F401
                                    write_chrome_trace)

__all__ = ["Span", "NoopRecorder", "FlightRecorder", "get_recorder",
           "set_recorder", "enabled", "new_trace_id", "new_span_id",
           "current_trace_id", "use_trace", "span", "emit_span"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished operation on a request's timeline.

    ``layer`` is the span taxonomy's coarse category (``router`` /
    ``scheduler`` / ``batch`` / ``kernel`` / ``cache`` / ``compile`` /
    ``job``), ``trace_id`` ties the span to the
    admission that minted it (empty for background work), ``t0``/``t1``
    are ``time.monotonic()`` seconds, ``attrs`` carries small JSON-able
    details (replica, bucket, shed reason, …), and ``pid`` is the
    recording process (0 = unattributed; the fleet-telemetry aggregator
    stamps worker pids so each worker renders as its own Chrome-trace
    process lane)."""
    name: str
    layer: str
    trace_id: str
    span_id: str
    parent_id: str
    t0: float
    t1: float
    thread: str
    attrs: Tuple[Tuple[str, object], ...] = ()
    pid: int = 0

    @property
    def duration_s(self) -> float:
        """Span length in seconds (always >= 0 for a closed span)."""
        return self.t1 - self.t0


class NoopRecorder:
    """The default recorder: tracing off.  ``enabled`` is False and every
    instrumentation site checks it before building a span, so the only
    per-request cost is that one check."""
    enabled = False

    def emit(self, span: Span) -> None:
        """Discard (never called on guarded sites; safe if it is)."""

    def spans(self) -> List[Span]:
        """Always empty."""
        return []


class FlightRecorder:
    """Bounded ring buffer of the most recent finished spans.

    ``capacity`` bounds memory (a deque of dataclasses — old spans fall
    off the back under sustained traffic, which is the point: the flight
    recorder answers "what just happened", not "what ever happened").
    ``dump_on(reason)`` writes the current ring as Chrome-trace JSON into
    ``dump_dir`` — wired to the crash/shed paths (`serve/scheduler.py::
    BatchScheduler.kill`, `serve/router.py::Router._shed`), deduped per
    reason so a shed storm produces one artifact, not thousands."""
    enabled = True

    def __init__(self, capacity: int = 4096,
                 dump_dir: Optional[str] = None):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self._ring: "deque[Span]" = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._dumped: Dict[str, str] = {}      # reason -> artifact path
        self.emitted = 0

    def emit(self, span: Span) -> None:
        """Append one finished span (oldest falls off past capacity)."""
        with self._lock:
            self._ring.append(span)
            self.emitted += 1

    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first."""
        with self._lock:
            return list(self._ring)

    def take_since(self, cursor: int) -> Tuple[List[Span], int]:
        """Spans emitted since a previous cursor (``(spans, new_cursor)``
        — start from cursor 0).  The incremental read the telemetry
        shipper batches over: spans that fell off the ring between reads
        are lost (bounded shipping is the contract), but nothing is ever
        shipped twice."""
        with self._lock:
            new = max(0, self.emitted - int(cursor))
            if new == 0:
                return [], self.emitted
            tail = list(self._ring)[-min(new, len(self._ring)):]
            return tail, self.emitted

    def clear(self) -> None:
        """Empty the ring (per-phase isolation in drivers/tests)."""
        with self._lock:
            self._ring.clear()

    def dump_on(self, reason: str) -> Optional[str]:
        """Dump the ring to ``dump_dir/flightrec-<reason>.json`` (Chrome
        trace format) the *first* time each reason fires; returns the
        artifact path, or None when ``dump_dir`` is unset / already
        dumped for this reason."""
        if not self.dump_dir:
            return None
        with self._lock:
            if reason in self._dumped:
                return None
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)
            path = os.path.join(self.dump_dir, f"flightrec-{safe}.json")
            self._dumped[reason] = path
        write_chrome_trace(path, self.spans(),
                           metadata={"dump_reason": reason})
        return path

    @property
    def dumps(self) -> Dict[str, str]:
        """``{reason: artifact path}`` of every dump taken so far."""
        with self._lock:
            return dict(self._dumped)


_RECORDER: object = NoopRecorder()
_trace_ids = itertools.count(1)
_span_ids = itertools.count(1)
_current: "contextvars.ContextVar[str]" = contextvars.ContextVar(
    "difet_trace_id", default="")


def get_recorder():
    """The process-global recorder (:class:`NoopRecorder` by default)."""
    return _RECORDER


def set_recorder(rec) -> object:
    """Install a recorder (returns the previous one).  Pass a
    :class:`FlightRecorder` to turn tracing on, :class:`NoopRecorder`
    to turn it off."""
    global _RECORDER
    prev, _RECORDER = _RECORDER, rec
    return prev


def enabled() -> bool:
    """Is tracing on?  The guard every instrumentation site checks
    before touching a clock or building a span."""
    return _RECORDER.enabled


def new_trace_id() -> str:
    """Mint a request trace id (process-unique; minted at router
    admission and propagated through every layer the request crosses)."""
    return f"t{os.getpid():x}-{next(_trace_ids):08x}"


def new_span_id() -> str:
    """Mint a span id (for parent/child links, e.g. batch → per-item)."""
    return f"s{next(_span_ids):08x}"


def current_trace_id() -> str:
    """The ambient trace id for this thread/context ('' when none) —
    how layers without a threaded-through id (the cache tiers) tag their
    spans."""
    return _current.get()


@contextlib.contextmanager
def use_trace(trace_id: str) -> Iterator[None]:
    """Set the ambient trace id for the duration of the block (restored
    on exit; cheap contextvar set/reset)."""
    tok = _current.set(trace_id)
    try:
        yield
    finally:
        _current.reset(tok)


def emit_span(name: str, layer: str, t0: float, t1: float, *,
              trace_id: Optional[str] = None, parent_id: str = "",
              span_id: Optional[str] = None, **attrs) -> Optional[str]:
    """Record an already-timed span (the scheduler computes queue-wait
    from stamps it takes anyway; no nested timing needed).  Returns the
    span id, or None when tracing is off."""
    rec = _RECORDER
    if not rec.enabled:
        return None
    sid = span_id or new_span_id()
    rec.emit(Span(name=name, layer=layer,
                  trace_id=(current_trace_id() if trace_id is None
                            else trace_id),
                  span_id=sid, parent_id=parent_id, t0=t0, t1=t1,
                  thread=threading.current_thread().name,
                  attrs=tuple(sorted(attrs.items())),
                  pid=os.getpid()))
    return sid


@contextlib.contextmanager
def span(name: str, layer: str, *, trace_id: Optional[str] = None,
         parent_id: str = "", **attrs) -> Iterator[None]:
    """Time a block and record it as one span.  When tracing is off this
    is one boolean check and a bare yield — the zero-cost-when-disabled
    contract the serving hot paths rely on."""
    rec = _RECORDER
    if not rec.enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        emit_span(name, layer, t0, time.monotonic(), trace_id=trace_id,
                  parent_id=parent_id, **attrs)

