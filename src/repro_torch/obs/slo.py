"""SLO burn-rate monitoring over the fleet-aggregated telemetry:
multi-window error-budget evaluation driving autoscaling signals and
flight-recorder dumps.  Port of ``repro/obs/slo.py`` (host code).

A single windowed p99 against a threshold is fine for scaling, but as an
*alert* it is both twitchy (one slow batch pages) and blind (a slow
constant burn never crosses it).  This module implements the standard
multi-window **burn rate** scheme instead: the SLO is "fraction
``objective`` of requests complete within ``latency_slo_s`` and are not
shed"; the remaining fraction is the
error budget; the burn rate over a window is the budget consumed per
unit budget allowed.  An alert requires the burn to exceed its
threshold over **both** a fast window (catches cliffs, seconds) and a
slow window (confirms it isn't a blip) — the fast window gives the
latency, the slow window the precision.

Inputs are the *fleet-aggregated* artifacts of `obs/agg.py`: the
admission→completion histogram (``difet.fleet.request_latency_s``,
fed by every worker's responses) and the typed shed counters — so an
N-process fleet is judged as one system.  On alert the monitor takes
exactly one deduped flight-recorder dump (``slo-burn-rate``), and its
windowed p99 is what `serve/fleet.py::Fleet.autoscale_tick` consumes
in telemetry mode — fleet-wide, not parent-only.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["SloPolicy", "BurnRateMonitor"]


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Burn-rate alerting policy.

    ``latency_slo_s``/``objective``: the SLO — a request is *good* when
    it completes within ``latency_slo_s`` and was not shed; fraction
    ``objective`` of requests must be good, the rest is error budget.
    ``fast_window_s``/``slow_window_s`` are the two evaluation windows;
    ``fast_burn``/``slow_burn`` their burn-rate thresholds (the classic
    page-severity pairing is 14.4x over 5m *and* 6x over 1h, scaled
    down here to serving-bench time constants)."""
    latency_slo_s: float = 0.5
    objective: float = 0.999
    fast_window_s: float = 5.0
    slow_window_s: float = 60.0
    fast_burn: float = 14.4
    slow_burn: float = 6.0


class BurnRateMonitor:
    """Multi-window burn-rate evaluator over one latency histogram plus
    shed counters (module docstring).

    ``tick()`` samples the inputs, evaluates both windows, and returns a
    report dict; when both windows breach, it requests one deduped
    flight-recorder dump (reason ``slo-burn-rate``) from the installed
    recorder.  Samples are kept just long enough to cover the slow
    window — bounded memory, like everything else in ``repro_torch.obs``."""

    DUMP_REASON = "slo-burn-rate"

    def __init__(self, hist: obs_metrics.Histogram,
                 shed_counters: Sequence[obs_metrics.Counter] = (),
                 policy: Optional[SloPolicy] = None,
                 clock=time.monotonic):
        self.hist = hist
        # a sequence of Counters, or a zero-arg callable returning one
        # (the router creates its typed shed counters lazily)
        self.shed_counters = (shed_counters if callable(shed_counters)
                              else tuple(shed_counters))
        self.policy = policy or SloPolicy()
        self.clock = clock
        # (t, bucket counts, total count, shed total) samples
        self._samples: "deque[Tuple[float, Tuple[int, ...], int, float]]" \
            = deque()
        self.alerts = 0
        self.last_report: Dict[str, object] = {}
        self._sample()                      # t0 baseline

    # -- sampling -------------------------------------------------------------
    def _shed_total(self) -> float:
        counters = (self.shed_counters() if callable(self.shed_counters)
                    else self.shed_counters)
        return float(sum(c.value for c in counters))

    def _sample(self) -> Tuple[float, Tuple[int, ...], int, float]:
        s = (self.clock(), self.hist.counts(), self.hist.count,
             self._shed_total())
        self._samples.append(s)
        horizon = s[0] - self.policy.slow_window_s - 1.0
        while len(self._samples) > 2 and self._samples[1][0] < horizon:
            self._samples.popleft()
        return s

    def _window_base(self, now: float, window_s: float):
        """The newest sample at least ``window_s`` old (or the oldest
        retained one, while history is still shorter than the window)."""
        base = self._samples[0]
        for s in self._samples:
            if now - s[0] >= window_s:
                base = s
            else:
                break
        return base

    # -- evaluation -----------------------------------------------------------
    def _good_cut(self) -> int:
        """Number of leading buckets whose upper edge is within the SLO
        (an observation in them is definitely good)."""
        n = 0
        for edge in self.hist.bounds:
            if edge <= self.policy.latency_slo_s:
                n += 1
            else:
                break
        return n

    def _window_burn(self, cur, base) -> Dict[str, object]:
        _, c0, n0, shed0 = base
        _, c1, n1, shed1 = cur
        delta = [a - b for a, b in zip(c1, c0)]
        total = max(0, n1 - n0)
        sheds = max(0.0, shed1 - shed0)
        cut = self._good_cut()
        good = sum(delta[:cut])
        bad = max(0, total - good) + sheds
        events = total + sheds
        budget = max(1e-9, 1.0 - self.policy.objective)
        burn = (bad / events) / budget if events else 0.0
        p99 = None
        if total:
            p99 = self.hist.quantile_since(c0, 0.99)
        return {"events": events, "bad": bad, "burn": burn, "p99": p99}

    def tick(self, now: Optional[float] = None) -> Dict[str, object]:
        """Sample + evaluate both windows.  Returns
        ``{"burn_fast", "burn_slow", "p99_fast", "alerting", "dump"}``
        (``dump`` is the artifact path the first time the alert fires,
        None otherwise — `FlightRecorder.dump_on` dedupes the reason)."""
        now = self.clock() if now is None else now
        cur = self._sample()
        fast = self._window_burn(cur, self._window_base(
            now, self.policy.fast_window_s))
        slow = self._window_burn(cur, self._window_base(
            now, self.policy.slow_window_s))
        alerting = (fast["burn"] >= self.policy.fast_burn
                    and slow["burn"] >= self.policy.slow_burn)
        dump = None
        if alerting:
            self.alerts += 1
            rec = obs_trace.get_recorder()
            if rec.enabled:
                dump = getattr(rec, "dump_on",
                               lambda _r: None)(self.DUMP_REASON)
        self.last_report = {
            "burn_fast": fast["burn"], "burn_slow": slow["burn"],
            "p99_fast": fast["p99"], "events_fast": fast["events"],
            "alerting": alerting, "dump": dump, "t": now}
        return self.last_report
