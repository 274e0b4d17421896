"""Unified observability: trace contexts, event log, metrics, exporters.

The paper's headline claims (5378 s, $97 for 100 TB) are *measured*
claims, and the repro measures the same quantities — but before this
package they lived in separate layers with no shared identity:
PhaseTimeline spans in the shuffle runtime, attempt-counting
MetricsMiddleware in the store stack, PeakTracker watermarks in the
reduce scheduler. This package supplies the shared identity and the two
export paths:

  context.py — TraceContext (job -> phase -> task -> worker), carried in
      a contextvars.ContextVar and explicitly re-bound across thread
      pools (contexts do NOT propagate to pool threads on their own).

  events.py  — the bounded, thread-safe EventLog plus the Tracer that
      every layer reports into: timeline spans, store request attempts,
      retries, governor grants, cluster round/death events.

  metrics.py — MetricsRegistry (counters / gauges / histograms keyed by
      name + labels) and the human-readable renderers the examples use
      for their end-of-run summaries.

  trace.py   — Chrome trace-event JSON export (perfetto /
      chrome://tracing loadable, workers as tracks).

Everything here is stdlib-only and import-cycle-free: io/ and shuffle/
import obs, never the reverse.
"""
from repro_torch.obs.context import (TraceContext, bind_context, current_context,
                               use_context)
from repro_torch.obs.events import EventLog, Tracer
from repro_torch.obs.metrics import MetricsRegistry, render_report
from repro_torch.obs.trace import chrome_trace, write_chrome_trace

__all__ = [
    "EventLog",
    "MetricsRegistry",
    "TraceContext",
    "Tracer",
    "bind_context",
    "chrome_trace",
    "current_context",
    "render_report",
    "use_context",
    "write_chrome_trace",
]
