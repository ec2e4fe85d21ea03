"""Search telemetry of the port (counterpart of ``repro.obs``; DESIGN.md
§8), wired through ``repro_torch.solver.Solver`` and
``repro_torch.service.SolverService`` behind ``SolverConfig.metrics`` /
``SolverConfig.trace_path``:

* :mod:`repro_torch.obs.registry` — counters / gauges / histograms with
  labels; the disabled registry hands out shared no-op instruments;
* :mod:`repro_torch.obs.trace` — the JSONL trace writer and the
  reference's per-kind record schema (``tools/trace_report.py`` reads
  the port's traces unchanged);
* :mod:`repro_torch.obs.collect` — the per-round collector both drivers
  call at round boundaries.  It copies the lane counters to the host once
  per round, after the round's own open-work readback, and feeds nothing
  back, so the search tree is bit-identical with telemetry on or off;
* :mod:`repro_torch.obs.spans` — host-time spans of each phase of a round
  and of each request, on by default and held in a bounded ring beside
  (not inside) the reference's trace schema; exported as a Chrome trace
  that loads beside ``torch.profiler``'s.
"""

from repro_torch.obs.collect import RoundCollector
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, MetricsSnapshot)
from repro_torch.obs.spans import Span, SpanRecorder
from repro_torch.obs.trace import (TRACE_KINDS, TRACE_SCHEMA_VERSION,
                                   TraceError, TraceWriter, read_trace,
                                   validate_record)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsSnapshot",
    "RoundCollector",
    "Span",
    "SpanRecorder",
    "TRACE_KINDS",
    "TRACE_SCHEMA_VERSION",
    "TraceError",
    "TraceWriter",
    "read_trace",
    "validate_record",
]
