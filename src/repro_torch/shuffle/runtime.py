"""The shuffle engine room: staging loops, streaming merges, governance.

Everything here used to live inside core/external_sort.py and was
sort-flavoured by accident, not by necessity: span timelines, job-wide
cancellation, the adaptive reduce-memory governor, bounded run cursors,
the reduce scheduler, and the prefetched map loop are workload-agnostic
once the workload-specific decisions are pushed behind the MapOp /
ReduceOp / PartitionReducer protocols (shuffle/api.py). The sort keeps
its exact byte behaviour — SortMapOp / MergeReduceOp (shuffle/sort.py)
wrap the same WaveSorter / k-way-merge bodies this code used to call
directly — and any other workload (shuffle/groupby.py) gets the same
staging, budget, and fault-recovery machinery for free.

Memory contract (the reduce side): up to `slots` streaming reducers run
concurrently, each holding at most `runs x chunk` decoded bytes, where
chunks are granted by the AdaptiveBudgetGovernor out of the plan's
global `reduce_memory_budget_bytes` — see the governor docstring for
the provable bound. Encoded output parts being sliced/uploaded sit on
top (~(1 + max_inflight_writes) x part bytes per active reducer).

Observability: PhaseTimeline's raw span list is capped at `max_spans`
(default 4096, a constructor knob) — per-phase totals stay exact past
the cap and the report's `spans_dropped` (surfaced by ShuffleReport and
ClusterShuffleReport alike) counts the overflow, so a huge run degrades
to aggregates instead of hoarding memory. Wire a `sink` (usually
obs/events.Tracer.timeline_sink()) to forward every span into the
unified event log as it is recorded; task execution binds an
obs TraceContext (phase/task/worker) around each map task and reduce
partition so store requests issued on behalf of a task — including
writes handed to staging pools — are attributed to it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io import staging
from repro_torch.io.backends import RetryableError, StoreBackend
from repro_torch.obs.context import (TraceContext, bind_context, current_context,
                               use_context)

from repro_torch.shuffle.api import MapOp, ReduceOp, require

# Attempt-unique suffix for governor/peak accounting keys: speculative
# duplicates of one partition run concurrently and must each hold their
# own grant — keying by partition id alone would leak or double-free.
_ATTEMPT_SEQ = itertools.count()


def _task_context(phase: str, task, tag_prefix: str) -> TraceContext:
    """The TraceContext for one task: narrows the ambient context (the
    cluster driver binds job/worker) or starts fresh on the single host."""
    base = current_context() or TraceContext(job="job")
    worker = tag_prefix.rstrip("/") or base.worker or "host"
    return base.with_phase(phase).with_task(task).with_worker(worker)


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded phase interval, seconds relative to the job start."""

    phase: str  # e.g. "map.compute", "reduce.upload"
    start: float
    end: float
    worker: str = ""  # "w3" map task / "r12" reducer tag

    @property
    def seconds(self) -> float:
        return self.end - self.start


class PhaseTimeline:
    """Thread-safe span recorder for the per-phase timeline.

    Aggregate per-phase totals are exact; the raw span list is capped at
    `max_spans` (oldest kept) so a huge run cannot hoard memory — the
    report's `spans_dropped` says how many were dropped. Because spans from overlapping
    threads both count wall time, a phase total larger than the enclosing
    stage's wall time is *measured overlap*, which is the point.
    """

    def __init__(self, origin: float, *, max_spans: int = 4096,
                 sink=None):
        self._origin = origin
        self._lock = threading.Lock()
        self._totals: dict[str, float] = {}
        self._spans: list[Span] = []
        self._max = int(max_spans)
        self._sink = sink  # callable(phase, abs_start, abs_end, worker_tag)
        self.dropped = 0

    def add(self, phase: str, start: float, end: float | None = None,
            *, worker: str = "") -> None:
        end = time.perf_counter() if end is None else end
        span = Span(phase, start - self._origin, end - self._origin, worker)
        with self._lock:
            self._totals[phase] = self._totals.get(phase, 0.0) + span.seconds
            if len(self._spans) < self._max:
                self._spans.append(span)
            else:
                self.dropped += 1
        if self._sink is not None:
            # Outside the lock: the sink (obs Tracer) has its own, and
            # it receives ABSOLUTE times — its clock origin may differ.
            self._sink(phase, start, end, worker)

    @contextlib.contextmanager
    def span(self, phase: str, worker: str = ""):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(phase, t, worker=worker)

    def totals(self) -> dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)


class PeakTracker:
    """Thread-safe global peak of summed per-reducer buffered merge bytes —
    the measurement behind the reduce_memory_budget_bytes guarantee."""

    def __init__(self):
        self._lock = threading.Lock()
        self._per: dict[int, int] = {}
        self._total = 0
        self.peak = 0

    def update(self, rid: int, nbytes: int) -> None:
        with self._lock:
            self._total += nbytes - self._per.get(rid, 0)
            self._per[rid] = nbytes
            if self._total > self.peak:
                self.peak = self._total

    def clear(self, rid: int) -> None:
        with self._lock:
            self._total -= self._per.pop(rid, 0)


class JobControl:
    """Job-wide cancellation + first-failure collection.

    Shared by every scheduler (and, in cluster mode, every worker) of one
    job: a real failure anywhere cancels the whole job, and the
    chronologically first exception is what the driver re-raises.
    """

    def __init__(self):
        self.cancel = threading.Event()
        self._lock = threading.Lock()
        self._first: list[BaseException] = []

    def fail(self, e: BaseException) -> None:
        with self._lock:
            if not self._first:
                self._first.append(e)
        self.cancel.set()

    @property
    def failed(self) -> bool:
        with self._lock:
            return bool(self._first)

    def raise_first(self) -> None:
        with self._lock:
            if self._first:
                raise self._first[0]


class AdaptiveBudgetGovernor:
    """Adaptive apportionment of the global reduce memory budget.

    Replaces the static active-count split: every registering reducer is
    granted the static fair share S0 = budget // slots (the floor
    reduce_chunking validates up front), and on every emit cycle it may
    `grow` its grant out of budget freed by retired reducers — so the
    tail of the reduce phase runs with bigger per-run chunks instead of
    leaving freed budget idle ("chunk sizes grow mid-merge").

    The budget bound is provable, not just measured:

      * bytes only move between the free pool and live grants under one
        lock, and the free pool never goes negative — so the sum of live
        grants never exceeds the budget;
      * a live reducer's grant (hence chunk) never shrinks — growth only
        draws from `free` beyond a reservation of S0 per not-yet-started
        partition (up to the slot count), so a late registrant never
        needs to claw back granted bytes;
      * each reducer buffers at most runs x chunk <= grant decoded bytes,
        so the measured all-reducer peak (reduce_peak_merge_bytes) is
        under the budget at every instant.

    With budget == 0 the governor is inert: every cursor just uses the
    merge_chunk_bytes cap.
    """

    def __init__(self, *, budget: int, chunk_cap: int, record_bytes: int,
                 slots: int, partitions: int, tracer=None):
        self.tracer = tracer  # obs Tracer: governor.grant_bytes histogram
        self.budget = int(budget)
        self.chunk_cap = int(chunk_cap)
        self.record_bytes = int(record_bytes)
        self.slots = max(int(slots), 1)
        self._cond = threading.Condition()
        self._free = self.budget
        self._live: dict[int, tuple[int, int]] = {}  # rid -> (runs, grant)
        # Completed rids as a SET, not a counter: a partition whose merge
        # retired but whose async commit later died (cluster worker
        # failure) is re-executed and retires AGAIN — dedup keeps the
        # unstarted-partition reservation from under-counting.
        self._done_rids: set[int] = set()
        self._partitions = int(partitions)
        self._base = self.budget // self.slots if self.budget else 0
        self.max_chunk_bytes = 0 if self.budget else self.chunk_cap

    def _chunk_of(self, runs: int, grant: int) -> int:
        return min(self.chunk_cap, grant // max(runs, 1))

    def register(self, rid: int, runs: int,
                 abort: Callable[[], bool] | None = None) -> int | None:
        """Reserve an initial grant; returns the per-run chunk in bytes.

        Blocks while the free pool cannot cover even one record per run
        (only possible transiently, while grown siblings hold surplus
        that their retirement will release). Returns None if `abort`
        turns true while waiting.
        """
        if not self.budget:
            return self.chunk_cap
        min_need = max(runs, 1) * self.record_bytes
        with self._cond:
            while self._free < min_need:
                if abort is not None and abort():
                    return None
                self._cond.wait(timeout=0.05)
            grant = max(min(self._base, runs * self.chunk_cap, self._free),
                        min_need)
            self._live[rid] = (runs, grant)
            self._free -= grant
            chunk = self._chunk_of(runs, grant)
            self.max_chunk_bytes = max(self.max_chunk_bytes, chunk)
        if self.tracer is not None:
            self.tracer.registry.observe("governor.grant_bytes", grant,
                                         event="register")
        return chunk

    def chunk_bytes(self, rid: int) -> int:
        if not self.budget:
            return self.chunk_cap
        with self._cond:
            runs, grant = self._live[rid]
            return self._chunk_of(runs, grant)

    def grow(self, rid: int) -> int:
        """Re-apportion freed budget into this reducer's grant (monotone);
        returns the current per-run chunk in bytes."""
        if not self.budget:
            return self.chunk_cap
        grew = 0
        with self._cond:
            runs, grant = self._live[rid]
            target = runs * self.chunk_cap
            if grant < target:
                # Keep S0 reserved for every partition that still has to
                # start (bounded by the free scheduler slots), so future
                # registrants are never starved by growth.
                unstarted = (self._partitions - len(self._done_rids)
                             - len(self._live))
                reserve = self._base * max(
                    0, min(self.slots - len(self._live), unstarted))
                avail = self._free - reserve
                extra = min(target - grant, avail // max(len(self._live), 1))
                if extra > 0:
                    grant += extra
                    self._live[rid] = (runs, grant)
                    self._free -= extra
                    grew = extra
            chunk = self._chunk_of(runs, grant)
            self.max_chunk_bytes = max(self.max_chunk_bytes, chunk)
        if grew and self.tracer is not None:
            self.tracer.registry.observe("governor.grant_bytes", grant,
                                         event="grow")
        return chunk

    def retire(self, rid: int, *, completed: bool = True) -> None:
        """Release the grant back to the free pool (waking any waiting
        registrant); `completed=False` marks a failed reducer whose
        partition will be re-executed (cluster failure recovery)."""
        if not self.budget:
            return
        with self._cond:
            entry = self._live.pop(rid, None)
            if entry is not None:
                self._free += entry[1]
            if completed:
                # Attempt keys are (partition, attempt) tuples when the
                # scheduler may run duplicate attempts (speculation);
                # done-accounting is per PARTITION either way.
                self._done_rids.add(rid[0] if isinstance(rid, tuple) else rid)
            self._cond.notify_all()


def reduce_chunking(plan, runs: int, active: int) -> tuple[int, int]:
    """(chunk_records, chunk_bytes) per run under the global budget.

    This is the STATIC fair split — the governor's starting point and the
    up-front feasibility check: with a budget, each of the `active`
    concurrent reducers gets an equal share, split over its `runs`
    cursors and capped at merge_chunk_bytes; the all-reducer total
    active x runs x chunk therefore never exceeds the budget. Without
    one, every cursor buffers merge_chunk_bytes. At runtime the adaptive
    governor only ever grants MORE than this (never less), drawing on
    budget freed by retired reducers.
    """
    rb = plan.record_bytes
    require(plan.merge_chunk_bytes >= rb, "merge_chunk_bytes",
            plan.merge_chunk_bytes,
            f"must hold at least one {rb}-byte record, else the "
            "reduce-memory bound cannot be met")
    chunk_bytes = plan.merge_chunk_bytes
    if plan.reduce_memory_budget_bytes:
        share = plan.reduce_memory_budget_bytes // max(active, 1)
        chunk_bytes = min(chunk_bytes, share // max(runs, 1))
        require(chunk_bytes >= rb, "reduce_memory_budget_bytes",
                plan.reduce_memory_budget_bytes,
                f"cannot give each of {active} concurrent reducers one "
                f"{rb}-byte record per run ({runs} runs each) — raise the "
                "budget or lower parallel_reducers")
    return chunk_bytes // rb, chunk_bytes


class RunCursor:
    """Bounded window over one spilled run's partition slice.

    Holds at most `chunk_records` decoded records at a time; `refill`
    issues one ranged GET for the next chunk, `take_upto` consumes the
    buffered prefix that is safe to emit (every record <= bound). The
    chunk size may be raised mid-stream (`set_chunk`) when the adaptive
    governor re-apportions budget freed by retired reducers.
    """

    __slots__ = ("_store", "_bucket", "_key", "_hi", "_next", "_chunk",
                 "_pw", "k64", "keys", "ids", "payload")

    def __init__(self, store, bucket, key, lo, hi, payload_words, chunk_records):
        self._store = store
        self._bucket = bucket
        self._key = key
        self._next = int(lo)
        self._hi = int(hi)
        self._chunk = int(chunk_records)
        self._pw = int(payload_words)
        self.keys = np.empty((0,), np.uint32)
        self.ids = np.empty((0,), np.uint32)
        self.payload = None
        self.k64 = np.empty((0,), np.uint64)

    @property
    def has_more_remote(self) -> bool:
        return self._next < self._hi

    @property
    def exhausted(self) -> bool:
        return not self.has_more_remote and self.k64.size == 0

    @property
    def buffered_bytes(self) -> int:
        return self.k64.size * rec.record_bytes(self._pw)

    def set_chunk(self, chunk_records: int) -> None:
        self._chunk = int(chunk_records)

    def refill(self) -> None:
        n = min(self._chunk, self._hi - self._next)
        start, length = rec.body_range(self._next, n, self._pw)
        body = self._store.get_range(self._bucket, self._key, start, length)
        self._next += n
        k, i, p = rec.decode_body(body, self._pw)
        self.keys, self.ids, self.payload = k, i, p
        self.k64 = k.astype(np.uint64) << np.uint64(32) | i.astype(np.uint64)

    def take_upto(self, bound):
        """Consume and return the (keys, ids, payload, k64) prefix with
        k64 <= bound; bound=None consumes everything buffered."""
        cut = self.k64.size if bound is None else int(
            np.searchsorted(self.k64, bound, side="right"))
        out = (self.keys[:cut], self.ids[:cut],
               None if self.payload is None else self.payload[:cut],
               self.k64[:cut])
        self.keys, self.ids = self.keys[cut:], self.ids[cut:]
        self.payload = None if self.payload is None else self.payload[cut:]
        self.k64 = self.k64[cut:]
        return out


def merge_fragments(frags, payload_words: int):
    """Merge already-sorted fragments (one per run) into one sorted batch.

    A plain stable argsort over the concatenated packed keys
    (key<<32|id) is the k-way merge of the emit window — small
    (≤ runs x chunk records) by construction, which is the whole point
    of the streaming reduce. Packed keys need NOT be unique across
    fragments (the group-by's (key, count) records collide routinely):
    ties keep a stable, deterministic order — fragment list order, then
    within-fragment order — so output bytes are reproducible, but a
    consumer must not assume distinct packed keys. The sort workload's
    gensort ids happen to be unique, which is what makes its merge
    windows totally ordered.
    """
    frags = [f for f in frags if f[3].size]
    if not frags:
        empty = np.empty((0,), np.uint32)
        pw = int(payload_words)
        return empty, empty, (np.empty((0, pw), np.uint32) if pw else None)
    if len(frags) == 1:
        k, i, p, _ = frags[0]
        return k, i, p
    # Fast path: the live fragments do not interleave (each ends at or
    # below the next one's start) — common at the tail of skewed
    # partitions, where a single run is left emitting. Concatenation IS
    # the stable merge: a boundary tie keeps fragment order, exactly
    # what the stable argsort below would produce, so the bytes are
    # identical and the O(n log n) re-sort is skipped.
    if all(frags[i][3][-1] <= frags[i + 1][3][0]
           for i in range(len(frags) - 1)):
        keys = np.concatenate([f[0] for f in frags])
        ids = np.concatenate([f[1] for f in frags])
        payload = (np.concatenate([f[2] for f in frags])
                   if payload_words else None)
        return keys, ids, payload
    k64 = np.concatenate([f[3] for f in frags])
    order = np.argsort(k64, kind="stable")
    keys = np.concatenate([f[0] for f in frags])[order]
    ids = np.concatenate([f[1] for f in frags])[order]
    payload = None
    if payload_words:
        payload = np.concatenate([f[2] for f in frags])[order]
    return keys, ids, payload


class SiblingFailed(Exception):
    """Internal: this reducer was cancelled because another one failed."""


class AttemptLost(Exception):
    """Internal: this attempt lost a speculative race — another attempt
    of the same task already committed durably, so finishing this one is
    pure wasted wall-clock (the phase join would wait for it). Raised
    from the cooperative abandonment checks (the map read gate, the
    reduce merge-window poll) and handled as a clean abort: the attempt
    unwinds through the normal cleanup path (multipart abort, grant
    retirement) and its scheduler keeps running."""


class _AbandonGatedReads:
    """Read-path store proxy for a speculative map attempt: every GET
    (and every get_chunks chunk) first consults the commit gate, and
    once another attempt of this task has durably committed the next
    check raises AttemptLost — the loser stops fetching at the next
    chunk boundary instead of dragging the phase join to its own finish
    line. Write paths are deliberately NOT gated: map spill bytes are
    deterministic functions of (task, plan, input), so a racing
    duplicate write is byte-identical and harmless — it is the chunked
    fetch loop that burns wall-clock on a straggler."""

    def __init__(self, inner, may_commit: Callable[[], bool]):
        self._inner = inner
        self._may_commit = may_commit

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _check(self) -> None:
        if not self._may_commit():
            raise AttemptLost()

    def get(self, *args, **kwargs):
        self._check()
        return self._inner.get(*args, **kwargs)

    def get_range(self, *args, **kwargs):
        self._check()
        return self._inner.get_range(*args, **kwargs)

    def get_chunks(self, *args, **kwargs):
        it = self._inner.get_chunks(*args, **kwargs)
        while True:
            self._check()
            try:
                chunk = next(it)
            except StopIteration:
                return
            yield chunk


def timed_part(timeline: PhaseTimeline, tag: str, mp, index: int,
               data: bytes) -> None:
    """Background part upload, recorded as a reduce.upload span."""
    t = time.perf_counter()
    mp.put_part(index, data)
    timeline.add("reduce.upload", t, worker=tag)


def timed_put(timeline: PhaseTimeline, tag: str, store, bucket: str,
              key: str, data: bytes, metadata: dict) -> None:
    """Background spill put, recorded as a map.spill span."""
    t = time.perf_counter()
    store.put(bucket, key, data, metadata=metadata)
    timeline.add("map.spill", t, worker=tag)


def finalize_session(timeline: PhaseTimeline, tag: str,
                     uploader: staging.AsyncWriter, mp,
                     on_done: Callable[[], None] | None = None, *,
                     commit_gate: Callable[[], bool] | None = None) -> None:
    """Background session finisher: wait for the partition's in-flight
    parts, then commit — or abort on any failure (a truncated commit
    would carry a self-consistent CRC etag IntegrityError can't catch).
    Running this off the merge thread is what lets a reducer's scheduler
    slot free while its tail uploads still stream (partition r's uploads
    overlap partition r+active's merge even at parallel_reducers=1).
    `on_done` fires only after the commit succeeds — the durability
    confirmation the cluster driver uses to decide what a dead worker
    still owed.

    `commit_gate` is the speculation loser-abort point: consulted after
    all parts land and immediately before the commit, a False answer
    (another attempt of this task already committed durably) aborts the
    session instead — no double commit, no on_done."""
    t = time.perf_counter()
    try:
        uploader.close()  # waits all parts; re-raises the first failure
    except BaseException:
        mp.abort()
        raise
    try:
        if commit_gate is not None and not commit_gate():
            mp.abort()
            return
        mp.complete()
    except BaseException:
        mp.abort()
        raise
    finally:
        timeline.add("reduce.upload_wait", t, worker=tag)
    if on_done is not None:
        on_done()


@dataclasses.dataclass
class ReduceShared:
    """Job-level shared state for one shuffle's reduce pass — shared
    across every ReduceScheduler (one on a single host, one per cluster
    worker), so the budget governor, peak accounting, cancellation, and
    timeline stay global while the schedulers stay per-worker. The
    workload enters only through `reduce_op`."""

    plan: "object"  # any dataflow plan (see api.validate_dataflow_plan)
    bucket: str
    reduce_op: ReduceOp
    governor: AdaptiveBudgetGovernor
    timeline: PhaseTimeline
    peak: PeakTracker
    control: JobControl


class ReduceScheduler:
    """One host's (or one emulated cluster worker's) reduce scheduler.

    Pulls partition ids from `pop_next` and runs up to `width` streaming
    reducers concurrently against `store`, sharing the job-level
    governor/peak/cancellation through `shared` and delegating the data
    to `shared.reduce_op` (sources + PartitionReducer sink). Failure
    taxonomy:

      * exceptions of a type in `fatal` mean THIS scheduler's worker died
        (shuffle/executor.WorkerFailure): the scheduler unwinds and
        re-raises so the cluster driver can re-execute unconfirmed
        partitions on survivors — the job keeps going;
      * any other exception is a job failure: it is recorded on
        shared.control (which cancels every scheduler) and the driver
        re-raises it after the barrier.

    A partition only counts as done (`on_done`) after its multipart
    session COMMITS — merge completion is not durability.
    """

    def __init__(self, store: StoreBackend, shared: ReduceShared, *,
                 width: int, runs_hint: int = 2, fatal: tuple = (),
                 tag_prefix: str = "", requeue: tuple = (),
                 on_requeue: Callable[[int, BaseException], bool] | None = None,
                 commit_gate: Callable[[int], bool] | None = None,
                 gate_poll: bool = False):
        self.store = store
        self.shared = shared
        self.width = max(int(width), 1)
        self.runs_hint = max(int(runs_hint), 1)
        self.fatal = tuple(fatal)
        self.tag_prefix = tag_prefix
        # Elastic-driver hooks. `requeue` exception types mean the
        # partition's INPUT vanished under it (correlated spill loss):
        # the attempt aborted cleanly, the scheduler stays alive, and
        # `on_requeue(r, exc)` decides whether the driver can recover
        # (True: hand the partition back for a later attempt) or the
        # loss is unexplained (False: job failure). `commit_gate(r)` is
        # threaded to finalize_session as the speculation loser-abort.
        # With `gate_poll`, the gate is ALSO polled between merge
        # windows so a losing attempt abandons mid-merge (AttemptLost)
        # instead of streaming its whole partition first — only enable
        # it when the gate is a cheap in-process predicate (the process
        # worker's gate is a parent RPC and stays commit-time-only).
        self.requeue = tuple(requeue)
        self.on_requeue = on_requeue
        self.commit_gate = commit_gate
        self.gate_poll = gate_poll

    def run(self, pop_next: Callable[[], int | None],
            on_done: Callable[[int], None] | None = None) -> None:
        """Drain partitions until the queue is empty, the job is
        cancelled, or this scheduler's worker dies (re-raised)."""
        shared = self.shared
        plan = shared.plan
        refill_pool = ThreadPoolExecutor(
            max_workers=min(16, max(2, self.runs_hint * self.width)),
            thread_name_prefix="reduce-refill")
        finishers = staging.AsyncWriter(
            max(plan.max_inflight_writes, self.width), max_workers=self.width,
            thread_name_prefix="reduce-finish")
        dead_lock = threading.Lock()
        dead: list[BaseException] = []
        dead_evt = threading.Event()

        def loop() -> None:
            while not (shared.control.cancel.is_set() or dead_evt.is_set()):
                try:
                    r = pop_next()
                except self.fatal as e:  # the worker died at the queue
                    with dead_lock:
                        dead.append(e)
                    dead_evt.set()
                    return
                if r is None:
                    return
                try:
                    self._reduce_one(r, refill_pool, finishers, on_done)
                except SiblingFailed:
                    pass  # aborted cleanly; the root cause is recorded
                except AttemptLost:
                    continue  # lost a speculative race; the winner committed
                except self.fatal as e:  # worker death: stop this scheduler
                    with dead_lock:
                        dead.append(e)
                    dead_evt.set()
                    return
                except self.requeue as e:  # input lost mid-merge
                    handled = False
                    if self.on_requeue is not None:
                        try:
                            handled = bool(self.on_requeue(r, e))
                        except BaseException as e2:
                            shared.control.fail(e2)
                            return
                    if not handled:
                        shared.control.fail(e)
                        return
                    continue  # the attempt aborted; the driver re-plans
                except BaseException as e:  # real failure: cancel the job
                    shared.control.fail(e)
                    return

        threads = [threading.Thread(target=loop, name=f"reduce-merge-{i}")
                   for i in range(self.width)]
        try:
            for t in threads:
                t.start()
        finally:
            for t in threads:
                t.join()
            refill_pool.shutdown(wait=True)
            try:
                finishers.close()  # re-raises the first finisher failure
            except self.fatal as e:
                # Death during commit: those partitions never confirmed,
                # so the cluster driver will re-execute them.
                with dead_lock:
                    dead.append(e)
            except BaseException as e:
                shared.control.fail(e)
        if dead:
            raise dead[0]

    # -- internals ---------------------------------------------------------

    def _reduce_one(self, r: int, refill_pool, finishers,
                    on_done: Callable[[int], None] | None) -> None:
        # The whole partition body runs under its TraceContext: the
        # ranged GETs (inline or via the refill pool), part uploads and
        # the finisher commit (captured by AsyncWriter.submit) are all
        # attributed to reduce task r on this worker.
        with use_context(_task_context("reduce", f"r{r}", self.tag_prefix)):
            self._reduce_one_inner(r, refill_pool, finishers, on_done)

    def _reduce_one_inner(self, r: int, refill_pool, finishers,
                          on_done: Callable[[int], None] | None) -> None:
        shared = self.shared
        plan = shared.plan
        op = shared.reduce_op
        store = self.store
        timeline = shared.timeline
        governor = shared.governor
        pw = op.payload_words
        rb = rec.record_bytes(pw)
        part_bytes = plan.output_part_records * rb
        tag = f"{self.tag_prefix}r{r}"
        slices, n_total = op.sources(r)
        registered = bool(slices)
        chunk_records = 0
        # Optional ReduceOp extension (shuffle/recursive's redirected
        # partitions): a sequential partition's sink concatenates runs in
        # source order instead of merging them, so its cursors drain ONE
        # AT A TIME — the budget grant covers a single run's chunk no
        # matter how many map tasks spilled, which is what removes the
        # reduce fan-in ceiling for partitions headed into another
        # shuffle round.
        seq_fn = getattr(op, "sequential_partition", None)
        sequential = bool(seq_fn(r)) if callable(seq_fn) else False
        # Grant/peak accounting keys by ATTEMPT, not partition: under
        # speculation two attempts of one partition can merge at once,
        # and each must hold (and release) its own budget grant for the
        # governor's bound to stay provable.
        akey = (r, next(_ATTEMPT_SEQ))
        if registered:
            chunk = governor.register(
                akey, 1 if sequential else len(slices),
                abort=shared.control.cancel.is_set)
            if chunk is None:
                raise SiblingFailed()
            chunk_records = chunk // rb
        # Everything past a successful register sits inside the
        # try/cleanup below (mp/uploader as None sentinels until
        # created): store.multipart() or a user ReduceOp.open() raising
        # must still retire the grant and abort any created session, or
        # re-execution would deduct the budget pool a second time.
        mp = None
        uploader = None

        def submit_part(data: bytes) -> None:
            nonlocal next_part
            idx, next_part = next_part, next_part + 1
            t = time.perf_counter()  # blocks under upload backpressure
            uploader.submit(timed_part, timeline, tag, mp, idx, data)
            timeline.add("reduce.upload_wait", t, worker=tag)

        try:
            cursors = [
                RunCursor(store, shared.bucket, key, lo, hi, pw,
                          chunk_records)
                for key, lo, hi in slices
            ]
            mp = store.multipart(shared.bucket, op.output_key(r),
                                 metadata=op.output_metadata(r, n_total))
            # max_inflight >= fanout, or the backpressure semaphore would
            # silently cap concurrent part uploads below the fan-out
            # width.
            uploader = staging.AsyncWriter(
                max(plan.max_inflight_writes, plan.part_upload_fanout),
                max_workers=plan.part_upload_fanout)
            sink = op.open(r, n_total)
            # Optional sink protocol extension: a sink that runs its own
            # execution stage (shuffle/sort._DeviceMergeSink's async
            # device merge) gets the timeline and this partition's tag
            # so its off-thread work records spans like everything else.
            if hasattr(sink, "bind_exec"):
                sink.bind_exec(timeline=timeline, tag=tag)
            # A sink that only knows its output size at the end
            # (aggregation) reserves part 0 for the deferred header and
            # streams body parts from index 1 — the out-of-order
            # multipart contract (parts are assembled by index at
            # complete()) is what makes this legal.
            first_part = 1 if sink.deferred_part0 else 0
            next_part = first_part
            outbuf = bytearray(sink.begin())
            if sequential:
                # Sequential drain: one cursor at a time, run slices
                # forwarded to the sink in source order (deterministic —
                # the same bytes at any parallelism or worker count).
                for ci, c in enumerate(cursors):
                    while True:
                        if shared.control.cancel.is_set():
                            raise SiblingFailed()
                        if (self.gate_poll and self.commit_gate is not None
                                and not self.commit_gate(r)):
                            raise AttemptLost()
                        if registered:
                            grown = governor.grow(akey) // rb
                            if grown != chunk_records:
                                chunk_records = grown
                                c.set_chunk(grown)
                        if c.k64.size == 0 and c.has_more_remote:
                            t = time.perf_counter()
                            c.refill()
                            timeline.add("reduce.fetch", t, worker=tag)
                        shared.peak.update(akey, c.buffered_bytes)
                        t = time.perf_counter()
                        frag = c.take_upto(None)
                        done = ci == len(cursors) - 1 and c.exhausted
                        body = sink.consume([frag], final=done)
                        if body:
                            outbuf += body
                        timeline.add("reduce.merge", t, worker=tag)
                        while len(outbuf) >= part_bytes:
                            submit_part(bytes(outbuf[:part_bytes]))
                            del outbuf[:part_bytes]
                        if c.exhausted:
                            break
                cursors = []
            while cursors:
                if shared.control.cancel.is_set():
                    raise SiblingFailed()
                if (self.gate_poll and self.commit_gate is not None
                        and not self.commit_gate(r)):
                    raise AttemptLost()
                if registered:
                    # Adaptive governor: soak up budget freed by retired
                    # reducers — the per-run chunk can only grow.
                    grown = governor.grow(akey) // rb
                    if grown != chunk_records:
                        chunk_records = grown
                        for c in cursors:
                            c.set_chunk(grown)
                need = [c for c in cursors
                        if c.k64.size == 0 and c.has_more_remote]
                if need:
                    t = time.perf_counter()
                    if len(need) == 1:
                        need[0].refill()
                    else:  # concurrent ranged GETs: one RTT per cycle
                        # bind_context: the shared refill pool's threads
                        # must issue these GETs as THIS partition's.
                        list(refill_pool.map(bind_context(RunCursor.refill),
                                             need))
                    timeline.add("reduce.fetch", t, worker=tag)
                shared.peak.update(akey,
                                   sum(c.buffered_bytes for c in cursors))
                t = time.perf_counter()
                # Safe emit bound: the smallest last-buffered key among
                # runs that still have un-fetched records — nothing
                # later can sort below it. When no run has remote data
                # left, everything buffered is emittable (and this is
                # guaranteed to be the final cycle: any cursor with
                # remote data would survive the exhausted filter).
                remote_tails = [c.k64[-1] for c in cursors
                                if c.has_more_remote]
                bound = min(remote_tails) if remote_tails else None
                frags = [c.take_upto(bound) for c in cursors]
                cursors = [c for c in cursors if not c.exhausted]
                body = sink.consume(frags, final=bound is None)
                if body:
                    outbuf += body
                timeline.add("reduce.merge", t, worker=tag)
                while len(outbuf) >= part_bytes:
                    submit_part(bytes(outbuf[:part_bytes]))
                    del outbuf[:part_bytes]
            # finalize can block on real merge work (the device sink's
            # in-flight window) — record it under reduce.merge so the
            # span is the COMPLETE scheduler-visible merge cost.
            t = time.perf_counter()
            tail, part0 = sink.finalize()
            timeline.add("reduce.merge", t, worker=tag)
            if tail:
                outbuf += tail
                while len(outbuf) >= part_bytes:
                    submit_part(bytes(outbuf[:part_bytes]))
                    del outbuf[:part_bytes]
            # >= 1 part always: a partition with no body bytes still
            # uploads its header (inline for header-first sinks, as the
            # deferred part 0 below otherwise).
            if outbuf or (next_part == first_part and part0 is None):
                submit_part(bytes(outbuf))
            if part0 is not None:
                t = time.perf_counter()
                uploader.submit(timed_part, timeline, tag, mp, 0, part0)
                timeline.add("reduce.upload_wait", t, worker=tag)
        except BaseException:
            # Setup, merge, or upload died mid-session: let in-flight
            # parts settle, then discard the session — never commit it.
            try:
                if uploader is not None:
                    uploader.drain()
            except BaseException:
                pass
            try:
                if mp is not None:
                    mp.abort()
            except BaseException:
                pass  # a dead worker's abort fails too; parts are orphaned
            finally:
                shared.peak.clear(akey)
                if registered:
                    governor.retire(akey, completed=False)
                if uploader is not None:
                    uploader.close()
            raise
        # Success: hand drain + complete to the finisher queue so this
        # scheduler slot frees while the tail parts still upload —
        # finishers.submit blocks once max(max_inflight_writes, width)
        # sessions await completion (cross-partition upload backpressure).
        shared.peak.clear(akey)
        if registered:
            governor.retire(akey)
        confirm = None if on_done is None else (lambda: on_done(r))
        gate = (None if self.commit_gate is None
                else (lambda: self.commit_gate(r)))
        finishers.submit(finalize_session, timeline, tag, uploader, mp,
                         confirm, commit_gate=gate)


#: Sentinel yielded through the prefetch pipeline when a map load
#: abandoned mid-fetch (AttemptLost): the consume loop skips the task —
#: no processing, no spills, no confirmation — and moves on.
_LOST = object()


def run_map_tasks(store: StoreBackend, bucket: str, map_op: MapOp,
                  pop_next: Callable[[], int | None], *, plan,
                  timeline: PhaseTimeline, control: JobControl,
                  tag_prefix: str = "",
                  on_done: Callable[[int], None] | None = None,
                  commit_gate: Callable[[int], bool] | None = None) -> None:
    """The staged map loop, shared by the single-host path and every
    cluster worker: claim tasks from `pop_next`, keep `prefetch_depth`
    split loads in flight ahead of processing (retry-aware against
    transient store stalls), and spill through one bounded write-behind
    queue.

    With `on_done` set (cluster mode), each task's spills are drained
    before it is confirmed — a worker that dies with spills in flight
    leaves the task unconfirmed (and re-executed) rather than
    half-spilled. Without it (single-host), the spill queue drains once
    at loop exit, so spill waits never serialize the wave pipeline.

    Pipelined mode (plan.map_pipeline true AND the MapOp implements the
    staged `device_step`/`encode_step` split, see shuffle/api.MapOp):
    instead of calling the monolithic `process`, each task's device
    stage and encode stage run on two single-thread stage executors with
    a two-deep in-flight window, so wave N's host decode (the prefetch
    threads, recorded as map.decode) overlaps wave N-1's device sort
    (map.device_sort) and wave N-2's spill encode (map.encode) — the
    paper's §2.4-§2.5 compute/transfer overlap applied WITHIN the map
    leg. Spill bytes, offsets, and confirmation order are identical to
    the monolithic path; only wall-clock concurrency (and the per-stage
    span names) change.

    `commit_gate(g)` (elastic speculation) is the loser-abort predicate:
    each task's load runs against a read-gated store view that raises
    AttemptLost once another attempt of that task has durably committed,
    so a straggling duplicate abandons its chunked fetch at the next
    chunk boundary instead of holding the phase open. The gate is also
    re-checked between load and process, skipping the compute/spill leg
    of an already-lost task outright.
    """
    popped: collections.deque[int] = collections.deque()
    pipelined = (bool(getattr(plan, "map_pipeline", False))
                 and hasattr(map_op, "device_step")
                 and hasattr(map_op, "encode_step"))

    def loads():
        # Pulled from inside the prefetch pipeline on the caller's
        # thread budget: each pull claims the next task (up to
        # prefetch_depth ahead of processing). A claimed-but-unconfirmed
        # task at death is simply re-executed by the driver's next round.
        # Each load is bound to ITS task's TraceContext at claim time:
        # task g+1's prefetched GETs must not be attributed to task g,
        # which is what the processing thread's ambient context says.
        while not control.cancel.is_set():
            g = pop_next()
            if g is None:
                return
            popped.append(g)
            ctx = _task_context("map", f"g{g}", tag_prefix)
            # AttemptLost must be absorbed INSIDE the thunk: escaping
            # the prefetch iterator would unwind the whole pipeline and
            # take the worker's other in-flight claims down with it.
            view = (store if commit_gate is None
                    else _AbandonGatedReads(store,
                                            lambda g=g: commit_gate(g)))
            if pipelined:
                def load_one(g=g, view=view):
                    t = time.perf_counter()
                    try:
                        data = map_op.load(view, bucket, g)
                    except AttemptLost:
                        return _LOST
                    timeline.add("map.decode", t, worker=f"{tag_prefix}g{g}")
                    return data
                yield bind_context(load_one, ctx)
            else:
                def load_one(g=g, view=view):
                    try:
                        return map_op.load(view, bucket, g)
                    except AttemptLost:
                        return _LOST
                yield bind_context(load_one, ctx)

    with staging.AsyncWriter(plan.max_inflight_writes) as spiller:
        task_iter = iter(staging.prefetch(
            loads(), depth=plan.prefetch_depth,
            retries=plan.io_retries, retry_on=(RetryableError,)))
        if pipelined:
            _run_map_pipelined(store, bucket, map_op, task_iter, popped,
                               timeline=timeline, tag_prefix=tag_prefix,
                               spiller=spiller, on_done=on_done,
                               commit_gate=commit_gate)
            return
        while True:
            t_wait = time.perf_counter()
            try:
                data = next(task_iter)
            except StopIteration:
                return
            g = popped.popleft()
            if data is _LOST or (commit_gate is not None
                                 and not commit_gate(g)):
                continue  # another attempt already committed this task
            tag = f"{tag_prefix}g{g}"
            timeline.add("map.wait", t_wait, worker=tag)
            # Processing runs under the task's TraceContext so spill puts
            # (captured by the spiller at submit) carry the attribution.
            with use_context(_task_context("map", f"g{g}", tag_prefix)):
                map_op.process(store, bucket, g, data, spiller=spiller,
                               timeline=timeline, tag=tag)
            if on_done is not None:
                spiller.drain()
                on_done(g)


def _run_map_pipelined(store, bucket, map_op, task_iter, popped, *,
                       timeline: PhaseTimeline, tag_prefix: str, spiller,
                       on_done: Callable[[int], None] | None,
                       commit_gate: Callable[[int], bool] | None = None
                       ) -> None:
    """The double-buffered stage executor behind run_map_tasks.

    Two single-thread pools — one per stage — keep stage order FIFO per
    stage while letting stages of different tasks overlap: the encode
    job for task N blocks on task N's device future, the single device
    thread runs task N+1's sort meanwhile, and the prefetch threads
    decode task N+2. The in-flight window is two tasks deep (claim task
    N only after task N-2's encode finished), bounding host memory at
    ~two waves of sorted output beyond what the monolithic loop holds.

    Failure semantics match the monolithic loop: the first stage
    exception (including a cluster WorkerFailure from a spill) re-raises
    here in task order, and `on_done` confirmation still happens only
    after THAT task's encode completed and its spills drained.
    """
    sort_pool = ThreadPoolExecutor(max_workers=1,
                                   thread_name_prefix="map-sort")
    enc_pool = ThreadPoolExecutor(max_workers=1,
                                  thread_name_prefix="map-encode")
    inflight: collections.deque = collections.deque()

    def finish_one() -> None:
        g, fut = inflight.popleft()
        fut.result()  # re-raises the task's first stage failure
        if on_done is not None:
            spiller.drain()
            on_done(g)

    try:
        while True:
            t_wait = time.perf_counter()
            try:
                data = next(task_iter)
            except StopIteration:
                break
            g = popped.popleft()
            if data is _LOST or (commit_gate is not None
                                 and not commit_gate(g)):
                continue  # another attempt already committed this task
            tag = f"{tag_prefix}g{g}"
            timeline.add("map.wait", t_wait, worker=tag)
            ctx = _task_context("map", f"g{g}", tag_prefix)
            sort_fut = sort_pool.submit(bind_context(
                lambda g=g, d=data, tag=tag: map_op.device_step(
                    g, d, timeline=timeline, tag=tag), ctx))
            enc_fut = enc_pool.submit(bind_context(
                lambda g=g, sf=sort_fut, tag=tag: map_op.encode_step(
                    store, bucket, g, sf.result(), spiller=spiller,
                    timeline=timeline, tag=tag), ctx))
            inflight.append((g, enc_fut))
            while len(inflight) >= 2:
                finish_one()
        while inflight:
            finish_one()
    finally:
        sort_pool.shutdown(wait=True)
        enc_pool.shutdown(wait=True)


__all__ = [
    "AdaptiveBudgetGovernor",
    "AttemptLost",
    "JobControl",
    "PeakTracker",
    "PhaseTimeline",
    "ReduceScheduler",
    "ReduceShared",
    "RunCursor",
    "SiblingFailed",
    "Span",
    "finalize_session",
    "merge_fragments",
    "reduce_chunking",
    "run_map_tasks",
    "timed_part",
    "timed_put",
]
