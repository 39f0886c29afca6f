"""Observability of the port's feature service (port of ``repro/obs``).

* ``metrics.py`` — lock-cheap counters/gauges and fixed-bucket histograms
  with bounded-memory p50/p95/p99 (a copy of the reference's);
* ``trace.py`` — structured span tracing into a bounded flight recorder,
  no-op by default, with its Chrome-trace dump (a copy of the reference's);
* ``profile.py`` — per-call and per-program stamps
  (`kernels/ops.py::match_best2` per shape bucket, the service's graph
  captures), plus ``torch.profiler`` capture.

The reference's fleet telemetry (``export.py`` beyond the Chrome dump,
``ship.py``, ``agg.py``, ``slo.py``) comes with the port of the fleet.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, registry, set_registry)
from repro_torch.obs.trace import (FlightRecorder, NoopRecorder,  # noqa: F401
                                   Span, get_recorder, set_recorder, enabled,
                                   new_trace_id, current_trace_id, use_trace,
                                   span, emit_span, spans_to_chrome,
                                   write_chrome_trace)
from repro_torch.obs.profile import (KernelProfiler, profiler,  # noqa: F401
                                     set_profiler, profile_call, record_call,
                                     record_compile, capture)
