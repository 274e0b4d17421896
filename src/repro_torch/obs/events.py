"""The event spine: a bounded EventLog and the Tracer every layer feeds.

Events are flat structured dicts on one monotonic clock (the Tracer's
perf_counter origin), so a reduce task's merge span and the ranged GETs
it issued sort onto one timeline. The log is bounded and drop-counting
like shuffle/runtime.PhaseTimeline: a huge run cannot hoard memory, and
the export records how much was dropped instead of silently truncating.

Event schema (every exporter consumes exactly this):

    {"name":   "reduce.fetch" | "store.get" | "cluster.round" | ...,
     "t":      seconds since the tracer origin (float),
     "dur":    span length in seconds (0.0 for instant events),
     "phase":  "map" | "reduce" | "",
     "task":   "g3" | "r12" | None,
     "worker": "w0" | "host" | "",
     ...:      free-form attrs (outcome, nbytes, tier, attempt, ...)}
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.obs.context import TraceContext, current_context
from repro_torch.obs.metrics import MetricsRegistry


class EventLog:
    """Bounded, thread-safe, append-only event buffer.

    Keeps the first `max_events` events (the PhaseTimeline convention:
    oldest kept, so the job's structure survives even when a long tail
    of store events overflows) and counts the rest in `dropped`.
    """

    def __init__(self, max_events: int = 65536):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._max = int(max_events)
        self.dropped = 0

    def emit(self, event: dict) -> None:
        with self._lock:
            if len(self._events) < self._max:
                self._events.append(event)
            else:
                self.dropped += 1

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


class Tracer:
    """One job's observability hub: EventLog + MetricsRegistry + clock.

    Created by ShuffleSession when the caller didn't bring one; passed
    explicitly (examples, benchmarks) when the same tracer should also
    see the store stack (io/middleware.TracingMiddleware) and span
    multiple jobs on one timeline. All event times are relative to
    `origin` — one perf_counter zero for spans and store attempts alike.
    """

    def __init__(self, job: str = "job", *, origin: float | None = None,
                 max_events: int = 65536,
                 registry: MetricsRegistry | None = None):
        self.job = job
        self.origin = time.perf_counter() if origin is None else float(origin)
        self.log = EventLog(max_events=max_events)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.root = TraceContext(job=job)

    # -- emission ----------------------------------------------------------

    def event(self, name: str, start: float, end: float | None = None, *,
              ctx: TraceContext | None = None, **attrs) -> None:
        """Record one event; `start`/`end` are absolute perf_counter
        readings. Attribution comes from `ctx`, defaulting to the
        calling thread's bound context (then the job root)."""
        if ctx is None:
            ctx = current_context() or self.root
        ev = {"name": name, "t": start - self.origin,
              "dur": 0.0 if end is None else max(end - start, 0.0),
              "phase": ctx.phase, "task": ctx.task, "worker": ctx.worker}
        if attrs:
            ev.update(attrs)
        self.log.emit(ev)

    def instant(self, name: str, *, ctx: TraceContext | None = None,
                **attrs) -> None:
        self.event(name, time.perf_counter(), ctx=ctx, **attrs)

    # -- timeline bridge ---------------------------------------------------

    def timeline_sink(self) -> Callable[[str, float, float, str], None]:
        """A PhaseTimeline `sink`: forwards every recorded span as an
        event, deriving attribution from the timeline's tag convention
        ("w0/g3" = worker w0, map task g3; a bare "r12" is the
        single-host driver, worker "host")."""

        def sink(phase: str, start: float, end: float, tag: str) -> None:
            worker, _, task = tag.rpartition("/")
            ctx = TraceContext(
                job=self.job, phase=phase.split(".", 1)[0],
                task=task or None, worker=worker or "host")
            self.event(phase, start, end, ctx=ctx)

        return sink


__all__ = ["EventLog", "Tracer"]
