"""Lock-cheap metrics primitives: counters, gauges, and fixed-bucket
histograms with bounded-memory quantile estimation.

A copy of ``repro/obs/metrics.py`` (plain Python; the port imports nothing
of the JAX package).  Appending one float per request to a list and
calling ``np.percentile`` on it would grow memory per request for the life
of the process and sort on every stats poll.  The
:class:`Histogram` here avoids that: observations land in a *fixed*
set of log-spaced buckets (one integer increment per observe, a few
hundred bytes total regardless of traffic), and ``quantile`` answers
p50/p95/p99 by cumulative-count walk + linear interpolation inside the
crossing bucket.  The price is bounded quantile error (one bucket width,
~12% with the default edges), which is exactly the precision an SLO
gate needs and all a production registry can afford.

:class:`MetricsRegistry` is the process-wide namespace: metrics are
created on first use under the ``difet.<layer>.<name>`` convention
and snapshot into one flat JSON-able dict (``MetricsRegistry.snapshot``).  Everything is
thread-safe; the hot paths take one short lock per observation.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_bounds", "registry", "set_registry"]


def default_bounds(lo: float = 1e-5, hi: float = 60.0,
                   factor: float = 1.25) -> Tuple[float, ...]:
    """Log-spaced histogram edges from ``lo`` to past ``hi`` (geometric
    ``factor`` steps) — the default covers 10 us .. 60 s, the span from a
    cache hit to a pathological queue stall, in ~70 buckets."""
    edges = [lo]
    while edges[-1] < hi:
        edges.append(edges[-1] * factor)
    return tuple(edges)


_DEFAULT_BOUNDS = default_bounds()


class Counter:
    """Monotonic counter.  ``inc`` is one lock + one add — cheap enough
    for admission paths; ``value`` reads the current total."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (default 1) to the counter."""
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        """Current total."""
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins instantaneous value (queue depth, replica count)."""

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        """Record the current level."""
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        """Most recently set level."""
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket histogram with bounded memory and interpolated
    quantiles.

    ``bounds`` are the (sorted, positive) bucket upper edges; an
    observation lands in the first bucket whose edge is >= the value
    (one binary search + one integer increment), values beyond the last
    edge land in a single overflow bucket.  Memory is
    ``len(bounds) + 1`` integers *forever* — ``tests/test_torch_obs.py`` holds
    this against 100k observations.

    ``quantile(q)`` walks the cumulative counts to the crossing bucket
    and linearly interpolates inside it (clamped by the tracked
    min/max), so the error is at most one bucket width."""

    def __init__(self, name: str, bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(bounds) if bounds \
            else _DEFAULT_BOUNDS
        if list(self.bounds) != sorted(self.bounds) or self.bounds[0] <= 0:
            raise ValueError("histogram bounds must be sorted and positive")
        self._counts = [0] * (len(self.bounds) + 1)   # +1 overflow bucket
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                                 # first edge >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, v: float) -> None:
        """Record one observation (seconds, bytes, whatever the metric's
        unit is) — O(log buckets), constant memory."""
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def observe_many(self, vs: Sequence[float]) -> None:
        """Bulk ``observe`` (one lock round-trip per value is fine; this
        exists for test/backfill ergonomics)."""
        for v in vs:
            self.observe(v)

    def _interpolate(self, counts: Sequence[int], total: int, q: float,
                     vmin: float, vmax: float) -> float:
        """Cumulative-count walk + linear interpolation over an arbitrary
        per-bucket count vector (the lifetime counts for `quantile`, a
        count *delta* for `quantile_since`)."""
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else vmax
                lo, hi = max(lo, vmin if hi >= vmin else lo), min(hi, vmax)
                if hi <= lo:
                    return lo
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
        return vmax

    def quantile(self, q: float) -> float:
        """Estimate the ``q``-quantile (0..1) by linear interpolation in
        the crossing bucket; 0.0 on an empty histogram."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self.count
            if total == 0:
                return 0.0
            counts = list(self._counts)
            vmin, vmax = self.min, self.max
        return self._interpolate(counts, total, q, vmin, vmax)

    def counts(self) -> Tuple[int, ...]:
        """Immutable per-bucket count snapshot (overflow bucket last) —
        the *baseline* for :meth:`quantile_since` windowed reads."""
        with self._lock:
            return tuple(self._counts)

    def quantile_since(self, baseline: Sequence[int],
                       q: float) -> Optional[float]:
        """Windowed quantile: the ``q``-quantile of only the observations
        recorded *since* ``baseline`` (a prior :meth:`counts` snapshot).
        Returns None when the window is empty — the SLO autoscaler's
        "no recent traffic" signal.  Interpolation is clamped by the
        lifetime min/max (the windowed extrema aren't tracked), so the
        error stays within one bucket width."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            cur = list(self._counts)
            vmin, vmax = self.min, self.max
        if len(baseline) != len(cur):
            raise ValueError("baseline shape mismatch (different bounds?)")
        window = [max(0, c - b) for c, b in zip(cur, baseline)]
        total = sum(window)
        if total == 0:
            return None
        return self._interpolate(window, total, q, vmin, vmax)

    def merge_counts(self, counts: Sequence[int], *, count: Optional[int] = None,
                     sum: float = 0.0, min: float = math.inf,
                     max: float = -math.inf) -> None:
        """Fold another histogram's per-bucket counts (or a counts
        *delta* between two snapshots) into this one, bucket-wise.  Both
        histograms must share the same ``bounds`` — under that invariant
        the merge is *exact*: the merged histogram is indistinguishable
        from one that observed the union stream (fleet telemetry
        merges per-replica histograms this way).
        ``count``/``sum`` are the observation count and value sum covered
        by ``counts`` (``count`` defaults to ``sum(counts)``);
        ``min``/``max`` widen the tracked extrema."""
        counts = [int(c) for c in counts]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"merge shape mismatch: {len(counts)} buckets vs "
                f"{len(self._counts)} (different bounds?)")
        n = int(count) if count is not None else 0
        if count is None:
            for c in counts:
                n += c
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self.count += n
            self.sum += float(sum)
            if min < self.min:
                self.min = float(min)
            if max > self.max:
                self.max = float(max)

    @property
    def mean(self) -> float:
        """Arithmetic mean of every observation (exact, not bucketed)."""
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        """Flat JSON-able summary: count/sum/min/max/mean + p50/p95/p99."""
        with self._lock:
            n, s = self.count, self.sum
            vmin = self.min if n else 0.0
            vmax = self.max if n else 0.0
        return {"count": n, "sum": s, "min": vmin, "max": vmax,
                "mean": (s / n if n else 0.0),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Process-wide named-metric namespace (``difet.<layer>.<name>``).

    ``counter``/``gauge``/``histogram`` create on first use and return
    the shared instance afterwards (one lock around the name map; the
    returned metric carries its own lock, so hot paths hold the registry
    lock only at creation).  ``snapshot()`` renders every metric into one
    flat dict for the metrics-JSON exporter."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        """The :class:`Counter` registered under ``name`` (created on
        first use; type mismatch with an existing name raises)."""
        m = self._get(name, lambda: Counter(name))
        if not isinstance(m, Counter):
            raise TypeError(f"{name} is a {type(m).__name__}, not Counter")
        return m

    def gauge(self, name: str) -> Gauge:
        """The :class:`Gauge` registered under ``name``."""
        m = self._get(name, lambda: Gauge(name))
        if not isinstance(m, Gauge):
            raise TypeError(f"{name} is a {type(m).__name__}, not Gauge")
        return m

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        """The :class:`Histogram` registered under ``name`` (``bounds``
        only applies at creation)."""
        m = self._get(name, lambda: Histogram(name, bounds))
        if not isinstance(m, Histogram):
            raise TypeError(f"{name} is a {type(m).__name__}, not Histogram")
        return m

    def names(self) -> List[str]:
        """Sorted registered metric names."""
        with self._lock:
            return sorted(self._metrics)

    def metrics(self) -> Dict[str, object]:
        """``{name: metric object}`` snapshot of the namespace (the
        metric objects themselves, not copies — the Prometheus exporter
        and the telemetry shipper walk this to read raw bucket counts)."""
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> Dict[str, object]:
        """Flat ``{name: value-or-histogram-summary}`` dict of every
        registered metric — the metrics-JSON payload."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in sorted(items):
            out[name] = m.snapshot() if isinstance(m, Histogram) else m.value
        return out

    def reset(self) -> None:
        """Drop every metric (tests + per-run isolation in drivers)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-default registry every layer instruments into."""
    return _REGISTRY


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-default registry (returns the previous one) —
    drivers use a fresh registry per run for clean per-run artifacts."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, reg
    return prev
