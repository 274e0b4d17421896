"""MetricsRegistry: labeled counters / gauges / histograms + renderers.

The aggregated side of the observability layer: where the EventLog keeps
individual occurrences, the registry keeps totals — request attempts vs
successes per (kind, outcome, tier), bytes per phase, retry-delay and
governor-grant histograms, re-executed task counts. One lock, plain-dict
snapshots, no dependencies — the report embeds `snapshot()` verbatim and
the benchmark artifacts are built from it.

`render()` / `render_report()` are the human-readable formatters the
examples print instead of hand-rolled f-strings.
"""
from __future__ import annotations

import threading

_Key = tuple  # (name, ((label, value), ...)) — hashable, sorted labels


def _key(name: str, labels: dict) -> _Key:
    return (name, tuple(sorted(labels.items())))


def _fmt(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe labeled metrics: counters, gauges, histograms.

    Counters accumulate, gauges overwrite, histograms keep summary
    moments (count / sum / min / max) — enough for the report and the
    benchmark trajectory without unbounded storage.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[_Key, float] = {}
        self._gauges: dict[_Key, float] = {}
        self._hists: dict[_Key, list[float]] = {}  # [count, sum, min, max]

    # -- writers -----------------------------------------------------------

    def counter(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                self._hists[k] = [1, value, value, value]
            else:
                h[0] += 1
                h[1] += value
                h[2] = min(h[2], value)
                h[3] = max(h[3], value)

    # -- readers -----------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        """The exact (name, labels) counter, 0 when never incremented."""
        with self._lock:
            return self._counters.get(_key(name, labels), 0)

    def total(self, name: str, **labels) -> float:
        """Sum of every `name` counter whose labels include `labels`
        (subset match) — e.g. total("store.requests", kind="get") sums
        over outcomes and tiers."""
        want = set(labels.items())
        with self._lock:
            return sum(v for (n, lbls), v in self._counters.items()
                       if n == name and want.issubset(lbls))

    def snapshot(self) -> dict:
        """Plain-dict copy: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, mean}}} with
        formatted `name{label=value,...}` keys, sorted for stable
        diffs/artifacts."""
        with self._lock:
            counters = {_fmt(k): v for k, v in self._counters.items()}
            gauges = {_fmt(k): v for k, v in self._gauges.items()}
            hists = {
                _fmt(k): {"count": h[0], "sum": h[1], "min": h[2],
                          "max": h[3], "mean": h[1] / h[0] if h[0] else 0.0}
                for k, h in self._hists.items()
            }
        return {"counters": dict(sorted(counters.items())),
                "gauges": dict(sorted(gauges.items())),
                "histograms": dict(sorted(hists.items()))}

    def render(self, prefix: str = "") -> list[str]:
        """Human-readable lines, optionally filtered by name prefix."""
        snap = self.snapshot()
        lines = []
        for section in ("counters", "gauges"):
            for name, v in snap[section].items():
                if name.startswith(prefix):
                    val = f"{v:g}" if isinstance(v, float) else str(v)
                    lines.append(f"{section[:-1]:<9s} {name:<56s} {val}")
        for name, h in snap["histograms"].items():
            if name.startswith(prefix):
                lines.append(
                    f"histogram {name:<56s} n={h['count']} "
                    f"mean={h['mean']:g} min={h['min']:g} max={h['max']:g}")
        return lines


def render_report(report) -> list[str]:
    """The standard end-of-run summary, formatted from any ShuffleReport
    or ClusterShuffleReport (duck-typed — no shuffle import). Replaces
    the hand-rolled [spans]/[requests]/per-tier f-strings the examples
    used to carry."""
    rep = getattr(report, "report", report)  # unwrap a cluster report
    lines = []

    ph = rep.phase_seconds or {}
    order = ("map.wait", "map.compute", "map.spill",
             "reduce.fetch", "reduce.merge", "reduce.upload")
    named = [n for n in order if n in ph] + sorted(set(ph) - set(order))
    if named:
        lines.append("[spans] " + "  ".join(
            f"{n}={ph[n]:.2f}s" for n in named))
    reduce_busy = sum(ph.get(k, 0.0) for k in
                      ("reduce.fetch", "reduce.merge", "reduce.upload"))
    if rep.reduce_seconds > 0 and reduce_busy > 0:
        lines.append(
            f"[spans] reduce concurrency: {reduce_busy:.2f}s of phase work "
            f"in {rep.reduce_seconds:.2f}s wall = "
            f"{reduce_busy / rep.reduce_seconds:.2f}x overlap")
    if rep.spans_dropped:
        lines.append(f"[spans] {rep.spans_dropped} spans beyond the "
                     "recorder cap were dropped (totals stay exact)")

    for tier, s in (rep.tier_stats or {}).items():
        lines.append(
            f"[{tier:>7s}] GET={s.get_requests} PUT={s.put_requests} "
            f"DEL={s.delete_requests} read={s.bytes_read / 1e6:.1f}MB "
            f"written={s.bytes_written / 1e6:.1f}MB throttled={s.throttled} "
            f"retries={s.retries} stall={s.stall_seconds:.2f}s")
    lines.append(
        f"[requests] total GET={rep.stats.get_requests} "
        f"PUT={rep.stats.put_requests} retries={rep.stats.retries} "
        f"throttled={rep.stats.throttled}")
    return lines


__all__ = ["MetricsRegistry", "render_report"]
