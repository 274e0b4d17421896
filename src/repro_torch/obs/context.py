"""TraceContext: the job -> phase -> task -> worker identity chain.

One frozen dataclass rides a contextvars.ContextVar through the whole
execution: the job sets the root, the map loop / reduce scheduler narrow
it per task, and the store middleware reads it to attribute every
GET/PUT attempt to the task that issued it.

The one sharp edge is threads: a ContextVar set on thread A is invisible
on a pool thread B, so every hand-off into a thread pool must re-bind
explicitly. `bind_context(fn)` captures the caller's context at bind
time and restores it around `fn` wherever it eventually runs — the
staging AsyncWriter does this for every submitted write, and the map
loop binds each prefetched split load to its task's context.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Where in the job the current code is running.

    `task` is the timeline tag convention: "g3" for map task 3, "r12"
    for reduce partition 12 (ints are accepted and normalized by the
    narrowing helpers' callers). `worker` is the cluster worker name
    ("w0"...) or "host" for the single-host driver.
    """

    job: str
    phase: str = ""  # "map" | "reduce" | "" (outside any phase)
    task: str | None = None
    worker: str = ""

    def with_phase(self, phase: str) -> "TraceContext":
        return dataclasses.replace(self, phase=phase)

    def with_task(self, task: "str | int | None") -> "TraceContext":
        return dataclasses.replace(
            self, task=task if task is None else str(task))

    def with_worker(self, worker: str) -> "TraceContext":
        return dataclasses.replace(self, worker=worker)


_CURRENT: contextvars.ContextVar[TraceContext | None] = contextvars.ContextVar(
    "repro_trace_context", default=None)


def current_context() -> TraceContext | None:
    """The TraceContext bound on this thread, or None outside any."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_context(ctx: TraceContext | None):
    """Bind `ctx` for the duration of the with-block (no-op for None)."""
    if ctx is None:
        yield
        return
    token = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def bind_context(fn: Callable, ctx: TraceContext | None = None) -> Callable:
    """Wrap `fn` so it runs under `ctx` (default: the context bound on
    the *calling* thread right now) wherever it is later invoked — the
    explicit re-bind that carries attribution across thread pools."""
    if ctx is None:
        ctx = current_context()
    if ctx is None:
        return fn

    def bound(*args, **kwargs):
        with use_context(ctx):
            return fn(*args, **kwargs)

    return bound


__all__ = ["TraceContext", "bind_context", "current_context", "use_context"]
