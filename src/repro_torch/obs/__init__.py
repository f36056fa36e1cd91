"""repro_torch.obs: observability of a session and of the serve front.

  telemetry  - ``GraphSession(telemetry=True | TelemetryConfig(...))``
               records a fixed-schema per-superstep ``TelemetrySeries``
               (returned on ``RunMetrics.telemetry``) on both scheduling
               backends, with no extra host read.
  trace      - every session owns a ``TraceRecorder`` (``session.trace``),
               enabled by ``TelemetryConfig.trace``, collecting spans on
               the profiler's clock (run and the drivers' phases,
               submit/detach, views built) with per-name ``totals()``,
               apply_updates batches, compactions and serve admissions;
               ``session.trace.export(path)`` writes Chrome/Perfetto
               trace-event JSON.
  serve      - ``ConcurrentServeScheduler.metrics`` records per-stream
               wait/service time and per-family queue depth with p50/p99
               summaries.
  slo        - sliding-window SLIs per family/tenant against declared
               ``SLOTarget``s, and a ``MetricsRegistry`` that snapshots
               every source to JSON and Prometheus text.
  loadgen    - deterministic open-loop arrivals, and ``OpenLoopHarness``,
               which serves them through a GraphSession and a
               ConcurrentServeScheduler.
  regress    - ``python -m repro_torch.obs.regress`` gates fresh
               benchmark records against a committed ``BENCH_*.json``
               trajectory (exit 0 clean, 1 regression, 2 usage or load
               error); imported by module, as the reference's is.

The reference's public names.
"""

from repro_torch.obs.telemetry import (TelemetryConfig, TelemetrySeries,
                                       HostSeriesBuilder, device_buffers,
                                       device_write, series_from_device,
                                       SERIES_FIELDS, GROUP_FIELDS)
from repro_torch.obs.trace import TraceRecorder, validate_trace_events
from repro_torch.obs.serve import (LatencyStats, ServeMetrics,
                                   percentile_summary)
from repro_torch.obs.slo import (SlidingWindowLatency, SLOTarget, SLOTracker,
                                 MetricsRegistry, validate_registry_snapshot,
                                 REGISTRY_SCHEMA)
from repro_torch.obs.loadgen import (LoadgenConfig, Arrival,
                                     generate_arrivals, OpenLoopHarness)

__all__ = [
    "TelemetryConfig", "TelemetrySeries", "HostSeriesBuilder",
    "device_buffers", "device_write", "series_from_device",
    "SERIES_FIELDS", "GROUP_FIELDS",
    "TraceRecorder", "validate_trace_events",
    "LatencyStats", "ServeMetrics", "percentile_summary",
    "SlidingWindowLatency", "SLOTarget", "SLOTracker",
    "MetricsRegistry", "validate_registry_snapshot", "REGISTRY_SCHEMA",
    "LoadgenConfig", "Arrival", "generate_arrivals", "OpenLoopHarness",
]
