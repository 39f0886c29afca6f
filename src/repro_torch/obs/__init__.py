"""Observability of the port: its engine, feature service and fleet
(port of ``repro/obs``).

* ``metrics.py`` — lock-cheap counters/gauges and fixed-bucket histograms
  with bounded-memory p50/p95/p99 (a copy of the reference's);
* ``trace.py`` — structured span tracing into a bounded flight recorder
  and onto ``torch.profiler``'s timeline, no-op by default: the service's
  and fleet's request spans, and the engine's map and reduce
  (`core/engine.py`: ``difet.extract``, ``difet.map``,
  ``difet.response.*``, ``difet.select.*``, ``difet.describe.*``,
  ``difet.reduce.*``), which the benchmark reads per stage;
* ``profile.py`` — per-call and per-program stamps
  (`kernels/ops.py::match_best2` per dispatch bucket, the matcher
  dispatch's probes, the service's graph captures), plus
  ``torch.profiler`` capture;
* ``export.py`` — Chrome-trace JSON + flat metrics JSON exporters, the
  Prometheus text renderer, the schema validator the smokes gate on, and
  the latency-breakdown report.

The fleet telemetry plane carries all of it across process boundaries:

* ``ship.py`` — worker-side periodic *delta* shipping (metric bucket
  deltas + span batches) over the mailbox ``telemetry/`` channel;
* ``agg.py`` — parent-side aggregation: exact bucket-wise histogram
  merges into ``difet.fleet.*``, cross-process span stitching onto one
  rebased timeline, worker-dump correlation;
* ``slo.py`` — multi-window SLO burn-rate monitoring over the
  aggregated fleet metrics, feeding the autoscaler and the flight
  recorder.

Drivers: ``python -m repro_torch.launch.obs`` (traced fleet run →
artifacts → report; ``--explain-dispatch`` decodes the dispatch cache;
``--fleet --smoke`` gates the cross-process telemetry plane).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricsRegistry, registry, set_registry)
from repro_torch.obs.trace import (FlightRecorder, NoopRecorder,  # noqa: F401
                                   Span, get_recorder, set_recorder, enabled,
                                   new_trace_id, current_trace_id, use_trace,
                                   span, emit_span)
from repro_torch.obs.profile import (KernelProfiler, profiler,  # noqa: F401
                                     set_profiler, record_call,
                                     record_compile, capture)
from repro_torch.obs.export import (spans_to_chrome,  # noqa: F401
                                    write_chrome_trace, metrics_payload,
                                    validate_chrome_trace,
                                    latency_breakdown, render_report,
                                    render_prometheus)
from repro_torch.obs.ship import (TelemetryShipper, span_to_wire,  # noqa: F401
                                  span_from_wire)
from repro_torch.obs.agg import (TelemetryAggregator,  # noqa: F401
                                 fleet_metric_name)
from repro_torch.obs.slo import BurnRateMonitor, SloPolicy  # noqa: F401
