"""The port's own spans (src/repro_torch/obs/device.py), as the
per-stage readers take them from a traced run.

`ms_per_call(ctx, *names)` is the device time launched while one of the
named spans was open, in ms per traced call: the union of the spans'
ranges, so an operation counts once where two of them overlap. Names
match whole, not by prefix. A program without such spans gives None,
as a run without a trace does.
"""
from __future__ import annotations

from perfbench.lib.devtrace import DeviceTrace


def seconds_in(trace: DeviceTrace, names) -> float:
    """Device seconds of the operations launched inside a host range
    named one of `names`."""
    picked = [("", s, e) for n, s, e in trace.ranges if n in names]
    if not picked:
        return 0.0
    return DeviceTrace(trace.ops, picked, trace.start,
                       trace.end).seconds_launched_in("")


def ms_per_call(ctx, *names: str):
    trace = getattr(ctx, "trace", None)
    calls = getattr(ctx, "trace_calls", 0)
    if trace is None or not calls:
        return None
    sec = seconds_in(trace, set(names))
    return 1e3 * sec / calls if sec > 0 else None

