"""Async double-buffered host<->device staging (paper §2.5 pipelining).

The paper gets map-download / shuffle / merge / reduce-upload overlap "for
free" from Ray's pipelined task execution: while a map task sorts block r,
the next input block r+1 is already downloading, and finished merge runs
upload while compute continues. Inside a round the XLA latency-hiding
scheduler overlaps collectives with compute (core/streaming.py); *between*
the store and the device there is no scheduler, so this module supplies the
overlap explicitly:

  prefetch(thunks, depth)  — double-buffered reader: keeps `depth` store
      reads in flight ahead of the consumer, so wave g+1's chunked GETs
      (io/backends.get_chunks) run while wave g is being sorted. Optionally
      retry-aware: transient store failures (e.g. a SlowDown that escaped
      a store-level RetryMiddleware) are re-issued with backoff instead of
      killing the pipeline.

  AsyncWriter(max_inflight) — bounded write-behind for spills/uploads.
      `submit` blocks once `max_inflight` writes are pending — the static
      analogue of the paper's merge controller withholding acks to
      back-pressure producers (§2.3) — so host memory holds at most
      max_inflight encoded runs. Multipart part uploads are part-indexed
      (io/backends.put_part(index, data)), so a multi-worker pool may
      complete them out of order and the assembled object is still exact;
      max_workers=1 remains available for genuinely order-sensitive
      submissions (it executes strictly in submission order).

Both are plain thread pools: store I/O is file I/O + numpy codec work that
releases the GIL, and device compute runs inside jit, so the overlap is
real even on CPU backends.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Type, TypeVar

from repro_torch.obs.context import current_context, use_context

T = TypeVar("T")


def prefetch(
    thunks: Iterable[Callable[[], T]],
    depth: int = 2,
    *,
    retries: int = 0,
    retry_on: tuple[Type[BaseException], ...] = (),
    retry_delay_s: float = 0.05,
) -> Iterator[T]:
    """Yield thunk() results in order with up to `depth` reads in flight.

    Double buffering is depth=2: one result being consumed, one loading.
    Exceptions from a thunk surface at the corresponding yield; unconsumed
    work is cancelled when the generator is closed.

    With `retries` > 0, a thunk that raises one of `retry_on` is re-run
    in place (exponential backoff from `retry_delay_s`) up to `retries`
    times before the error surfaces — so a transient store stall costs a
    delay, not the whole wave pipeline.
    """
    assert depth >= 1
    assert retries >= 0

    def attempt(thunk: Callable[[], T]) -> T:
        for k in range(retries + 1):
            try:
                return thunk()
            except retry_on:
                if k == retries:
                    raise
                time.sleep(retry_delay_s * (2.0 ** k))
        raise AssertionError("unreachable")

    run = attempt if retries and retry_on else (lambda thunk: thunk())
    ex = ThreadPoolExecutor(max_workers=depth, thread_name_prefix="stage-read")
    it = iter(thunks)
    pending: collections.deque[Future] = collections.deque()
    try:
        exhausted = False
        while True:
            while not exhausted and len(pending) < depth:
                try:
                    pending.append(ex.submit(run, next(it)))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            yield pending.popleft().result()
    finally:
        for f in pending:
            f.cancel()
        ex.shutdown(wait=True, cancel_futures=True)


class AsyncWriter:
    """Bounded write-behind queue for store puts (spill / output upload).

    max_inflight bounds how many submissions may be pending (backpressure);
    max_workers (default = max_inflight) is the pool width. max_workers=1
    gives strict FIFO execution for order-sensitive submissions; part-
    indexed multipart uploads (put_part(index, data)) don't need it — the
    reduce path fans parts out over max_workers=part_upload_fanout.
    """

    def __init__(self, max_inflight: int = 2, *, max_workers: int | None = None,
                 thread_name_prefix: str = "stage-write"):
        assert max_inflight >= 1
        self._ex = ThreadPoolExecutor(
            max_workers=max_workers or max_inflight,
            thread_name_prefix=thread_name_prefix,
        )
        self._slots = threading.Semaphore(max_inflight)
        self._futures: list[Future] = []
        self._exc_lock = threading.Lock()
        self._first_exc: BaseException | None = None

    def submit(self, fn: Callable, *args, **kwargs) -> Future:
        """Queue fn(*args); blocks while `max_inflight` writes are pending
        (backpressure — the merge-controller ack analogue)."""
        self._slots.acquire()
        # TraceContexts don't cross thread pools on their own: capture the
        # submitter's context here so the write's store requests are
        # attributed to the task that queued them, not the pool thread.
        ctx = current_context()

        def run():
            try:
                with use_context(ctx):
                    return fn(*args, **kwargs)
            except BaseException as e:
                # Record the *chronologically first* failure: with several
                # writer threads, the future list's order is submission
                # order, not failure order, and the root cause is whichever
                # upload broke first (later ones often fail as fallout).
                with self._exc_lock:
                    if self._first_exc is None:
                        self._first_exc = e
                raise
            finally:
                self._slots.release()

        f = self._ex.submit(run)
        self._futures.append(f)
        return f

    @property
    def failed(self) -> bool:
        """True once any submitted write has raised (drain will re-raise
        it). Lets order-dependent consumers — e.g. the task that would
        commit a multipart upload after its part uploads — turn a
        completed-but-broken pipeline into an abort instead."""
        with self._exc_lock:
            return self._first_exc is not None

    def drain(self) -> None:
        """Wait for all pending writes; re-raises the first failure (by
        failure time) with its original traceback."""
        futures, self._futures = self._futures, []
        for f in futures:
            f.exception()  # wait without raising; first_exc decides below
        with self._exc_lock:
            exc, self._first_exc = self._first_exc, None
        if exc is not None:
            raise exc

    def close(self) -> None:
        try:
            self.drain()
        finally:  # never leak the worker thread, even when drain raises
            self._ex.shutdown(wait=True)

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception; just stop the pool
            self._ex.shutdown(wait=True, cancel_futures=True)
