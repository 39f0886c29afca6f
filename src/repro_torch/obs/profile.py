"""Kernel profiling hooks: per-call wall and per-program capture stamps,
plus ``torch.profiler`` trace capture.

Port of ``repro/obs/profile.py``.  :class:`KernelProfiler` makes hot calls
attributable: when enabled, `kernels/ops.py::match_best2` synchronizes the
device after its result and stamps the wall time under ``(metric, path,
shape bucket)``, and the service's warm-up (`serve/buckets.py::warmup`)
stamps each program's build seconds (the CUDA-graph capture on the card).
Disabled (the default), the only cost is one boolean check per call site,
and no call gains a synchronization point: profiling must never change the
asynchronous launches of an unprofiled run.

For whole-program traces, :func:`capture` wraps a block in
``torch.profiler.profile`` and writes a Chrome trace under ``logdir``.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

__all__ = ["KernelProfiler", "profiler", "set_profiler", "profile_call",
           "record_call", "record_compile", "capture"]


class KernelProfiler:
    """Accumulates per-key call/compile stamps (bounded: one row per
    distinct key — keys are dispatch buckets / program ids, a small
    closed set).

    A row holds ``calls``, total/last wall seconds, and compile seconds
    when a compile was attributed to the key.  ``snapshot()`` renders
    rows JSON-able for the metrics exporter."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._rows: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    def _row(self, key: str) -> Dict[str, float]:
        r = self._rows.get(key)
        if r is None:
            r = self._rows[key] = {"calls": 0, "wall_s": 0.0,
                                   "last_wall_s": 0.0, "compile_s": 0.0,
                                   "compiles": 0}
        return r

    def record_call(self, key: str, wall_s: float) -> None:
        """Stamp one timed call under ``key``."""
        with self._lock:
            r = self._row(key)
            r["calls"] += 1
            r["wall_s"] += wall_s
            r["last_wall_s"] = wall_s

    def record_compile(self, key: str, compile_s: float) -> None:
        """Attribute one program build (a graph capture, or the first
    eager call) to ``key``."""
        with self._lock:
            r = self._row(key)
            r["compiles"] += 1
            r["compile_s"] += compile_s

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{key: row}`` copy of every profiled key."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._rows.items())}

    def reset(self) -> None:
        """Drop every row (per-run isolation)."""
        with self._lock:
            self._rows.clear()


class _NoopProfiler(KernelProfiler):
    """Disabled profiler: instrumentation sites see ``enabled=False``
    and skip timing entirely."""

    def __init__(self):
        super().__init__(enabled=False)


_PROFILER: KernelProfiler = _NoopProfiler()
_captures = itertools.count(1)


def profiler() -> KernelProfiler:
    """The process-global profiler (disabled by default)."""
    return _PROFILER


def set_profiler(p: KernelProfiler) -> KernelProfiler:
    """Install a profiler (returns the previous one); pass
    ``KernelProfiler()`` to enable, ``None``-like noop to disable."""
    global _PROFILER
    prev, _PROFILER = _PROFILER, p
    return prev


def record_call(key: str, wall_s: float) -> None:
    """Module-level convenience for :meth:`KernelProfiler.record_call`
    (no-op when profiling is disabled)."""
    p = _PROFILER
    if p.enabled:
        p.record_call(key, wall_s)


def record_compile(key: str, compile_s: float) -> None:
    """Module-level convenience for :meth:`KernelProfiler.record_compile`
    (no-op when profiling is disabled)."""
    p = _PROFILER
    if p.enabled:
        p.record_compile(key, compile_s)


@contextlib.contextmanager
def profile_call(key: str, *, block=None) -> Iterator[None]:
    """Time a block under ``key`` when profiling is enabled (one boolean
    check otherwise).  ``block`` (optional) is called with no args before
    the clock stops — pass ``torch.cuda.synchronize`` so queued device
    work is actually on the clock."""
    p = _PROFILER
    if not p.enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        if block is not None:
            block()
        p.record_call(key, time.monotonic() - t0)


@contextlib.contextmanager
def capture(logdir: Optional[str]) -> Iterator[bool]:
    """``torch.profiler`` capture around a block (host ops, and the
    card's kernels and copies where CUDA is available), written as a
    Chrome trace ``trace-<pid>-<n>.json`` under ``logdir``.  Yields True
    while a capture runs, False when ``logdir`` is unset (nothing is
    captured).  A capture that fails raises."""
    if not logdir:
        yield False
        return
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield True
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{next(_captures)}.json")
    prof.export_chrome_trace(path)
