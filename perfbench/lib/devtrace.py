"""The device's side of a traced window, from torch.profiler.

`capture(fn)` runs `fn` under the profiler (CPU and CUDA activities),
synchronises, and returns a DeviceTrace on the host's perf_counter clock:
the device operations (kernels, copies, sets) with the host time of the
call that launched each, and the host ranges that `record_function`
opened. The readers of the per-layer metrics and the result's
`breakdown` take what they need from it.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import torch

_SHORT = 64  # characters of an operation's name kept in the breakdown


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start: float
    end: float
    launched: float | None  # host time of the launching call, if known


class DeviceTrace:
    def __init__(self, ops: list[Op], ranges: list[tuple[str, float, float]],
                 start: float, end: float):
        self.ops = sorted(ops, key=lambda o: o.start)
        self.ranges = ranges
        self.start, self.end = start, end

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the operations' intervals inside the window."""
        out: list[list[float]] = []
        for o in self.ops:
            a, b = max(o.start, self.start), min(o.end, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def seconds(self, sub: str) -> float:
        """Device seconds of the operations whose name holds `sub`."""
        return sum(o.end - o.start for o in self.ops if sub in o.name)

    def seconds_launched_in(self, prefix: str) -> float:
        """Device seconds of the operations launched while a host range
        whose name starts with `prefix` was open."""
        spans: list[list[float]] = []
        for s, e in sorted((s, e) for n, s, e in self.ranges
                           if n.startswith(prefix)):
            if spans and s <= spans[-1][1]:
                spans[-1][1] = max(spans[-1][1], e)
            else:
                spans.append([s, e])
        starts = [s for s, _ in spans]
        total = 0.0
        for o in self.ops:
            if o.launched is None:
                continue
            i = bisect.bisect_right(starts, o.launched) - 1
            if i >= 0 and o.launched <= spans[i][1]:
                total += o.end - o.start
        return total

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for o in self.ops:
            key = o.name[:_SHORT]
            by[key] = by.get(key, 0.0) + (o.end - o.start)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, host_spans, n: int = 10) -> list[list]:
        """The `n` longest gaps in the window when the device ran
        nothing, each named by the innermost host span (name, start,
        end) open at the gap's start ("host" where none was)."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            open_ = [(e - s, name) for name, s, e in host_spans
                     if s <= a < e]
            out.append([min(open_)[1] if open_ else "host", b - a])
        return out


def capture(fn, *args, **kwargs):
    """Run fn(*args, **kwargs) under torch.profiler; returns (result,
    DeviceTrace). The window runs from just before the call to the
    synchronise after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        offset = time.time_ns() - time.perf_counter_ns()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()

    def clock(ns: int) -> float:
        return (ns - offset) / 1e9

    launched: dict[int, float] = {}
    ranges, device = [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if e.duration_ns() > 0:
                device.append(e)
        elif e.is_user_annotation():
            ranges.append((e.name(), clock(e.start_ns()),
                           clock(e.start_ns() + e.duration_ns())))
        elif e.name().startswith(("cuda", "cu")) and e.correlation_id():
            launched[e.correlation_id()] = clock(e.start_ns())
    # record_function ranges appear on the device's timeline too; they
    # are not work the device did.
    names = {r[0] for r in ranges}
    device = [e for e in device if e.name() not in names
              and not e.is_user_annotation()]
    ops = [Op(e.name(), clock(e.start_ns()),
              clock(e.start_ns() + e.duration_ns()),
              launched.get(e.correlation_id())) for e in device]
    return out, DeviceTrace(ops, ranges, t0, t1)


def idle_share(trace: DeviceTrace | None):
    """Percent of the traced window in which the device ran nothing;
    None without a trace or where the device ran nothing at all."""
    if trace is None or trace.window_s <= 0:
        return None
    busy = trace.busy_s()
    return 100.0 * (1.0 - busy / trace.window_s) if busy > 0 else None
