"""Chrome trace-event JSON export: the job as tracks per worker.

Produces the `{"traceEvents": [...]}` format both chrome://tracing and
https://ui.perfetto.dev load directly. Each worker ("w0".."wN" in
cluster mode, "host" single-host) is one named thread track; spans are
"X" (complete) events in microseconds, instants (retries, worker
deaths, round barriers) are "i" events. Event args carry the structured
attribution — phase, task, outcome, bytes, tier — so a store GET can be
traced back to the reduce partition that issued it by clicking it.

See docs/OBSERVABILITY.md for how to read a failover run's trace.
"""
from __future__ import annotations

import json

from repro_torch.obs.events import Tracer

_CORE = ("name", "t", "dur", "worker")


def chrome_trace(tracer: Tracer) -> dict:
    """Convert the tracer's event log to a Chrome trace-event dict.

    Track (tid) assignment is by sorted worker name, so the same fleet
    always gets the same track order — stable across runs and
    deterministic under fixed scheduling.
    """
    events = tracer.log.events()
    workers = sorted({e.get("worker") or "host" for e in events})
    tid = {w: i + 1 for i, w in enumerate(workers)}

    out: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": 1, "tid": 0,
        "args": {"name": tracer.job},
    }]
    for w in workers:
        out.append({"ph": "M", "name": "thread_name", "pid": 1,
                    "tid": tid[w], "args": {"name": w}})
    for e in events:
        w = e.get("worker") or "host"
        args = {k: v for k, v in e.items()
                if k not in _CORE and v is not None and v != ""}
        rec = {"name": e["name"], "pid": 1, "tid": tid[w],
               "ts": round(e["t"] * 1e6, 3),
               "cat": e.get("phase") or "job", "args": args}
        if e["dur"] > 0:
            rec["ph"] = "X"
            rec["dur"] = round(e["dur"] * 1e6, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant marker
        out.append(rec)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {"job": tracer.job,
                      "events_dropped": tracer.log.dropped},
    }


def write_chrome_trace(path: str, tracer: Tracer) -> dict:
    """Write the Chrome trace JSON to `path`; returns the dict too."""
    trace = chrome_trace(tracer)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    return trace


__all__ = ["chrome_trace", "write_chrome_trace"]
