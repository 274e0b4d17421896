"""Multi-worker shuffle execution: workers, stealing, failure recovery.

The cluster machinery of core/cluster.py, carved free of the sort: a
`Worker` is a name, a store view, and two phase entry points; the phase
driver runs rounds of surviving workers over a stealing task pool and
re-executes whatever a dead worker never durably confirmed. Nothing here
knows what a map task or a reduce partition *contains* — that arrives
through the WorkerContext's MapOp / ReduceShared, so the same executor
(and the same FaultyWorker / KillSwitchMiddleware failure injection)
drives CloudSort and the group-by aggregation alike. See
core/cluster.py's module docstring for the §2.4/§2.6 paper mapping; the
semantics are unchanged.
"""
from __future__ import annotations

import abc
import collections
import dataclasses
import threading
from typing import Callable, Mapping, Sequence

from repro_torch.io.backends import StoreBackend
from repro_torch.io.middleware import KillSwitchMiddleware, MetricsMiddleware
from repro_torch.obs.context import TraceContext, use_context

from repro_torch.shuffle import runtime as rt
from repro_torch.shuffle.api import MapOp, require


class WorkerFailure(RuntimeError):
    """An emulated worker died. Deliberately NOT a RetryableError: store
    retries cannot resurrect a host, only the driver's re-execution can."""


class ClusterFailure(RuntimeError):
    """The job cannot make progress (e.g. every worker died)."""


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How the job is partitioned across emulated workers.

    `fail_after_tasks[i]` / `fail_after_requests[i]` inject a death into
    worker i (wrapping it in FaultyWorker): the worker completes that
    many tasks / store requests, then dies. Used by the fault-tolerance
    tests and benchmarks; production runs leave them empty.
    """

    num_workers: int = 2
    fail_after_tasks: Mapping[int, int] = dataclasses.field(
        default_factory=dict)
    fail_after_requests: Mapping[int, int] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        require(self.num_workers >= 1, "num_workers", self.num_workers,
                "must partition the job across >= 1 worker")
        for knob in ("fail_after_tasks", "fail_after_requests"):
            for i, budget in getattr(self, knob).items():
                require(0 <= i < self.num_workers, knob, {i: budget},
                        f"names worker {i}, outside 0..{self.num_workers - 1}")
                require(budget >= 0, knob, {i: budget},
                        "injected budgets must be >= 0")


@dataclasses.dataclass
class WorkerContext:
    """Everything a worker needs to execute one job's tasks. The
    workload enters only through `map_op` / `reduce_shared.reduce_op`."""

    plan: "object"  # any dataflow plan (api.validate_dataflow_plan)
    bucket: str
    map_op: MapOp
    reduce_shared: rt.ReduceShared
    timeline: rt.PhaseTimeline
    control: rt.JobControl
    num_map_tasks: int = 0  # refill-pool sizing hint (runs per partition)
    # Elastic-driver hooks (shuffle/elastic.py); None/empty under the
    # round-barriered PhaseDriver. All take the worker NAME first so one
    # context serves the whole fleet. `commit_gate(worker, r)` is asked
    # immediately before a reduce partition's multipart commit (the
    # speculation loser-abort) and, for in-thread workers, polled
    # between merge windows so a losing attempt abandons mid-merge;
    # `map_commit_gate(worker, g)` is the map-phase analogue, polled
    # per fetched chunk through the read-gated store view; `requeue_on`
    # exception types mean a reduce input vanished (correlated spill
    # loss) and are routed to `on_requeue(worker, r, exc) -> handled`
    # instead of failing the job.
    commit_gate: Callable[[str, int], bool] | None = None
    map_commit_gate: Callable[[str, int], bool] | None = None
    requeue_on: tuple = ()
    on_requeue: Callable[[str, int, BaseException], bool] | None = None


class Worker(abc.ABC):
    """One emulated cluster worker.

    The protocol is two phase entry points plus a store view. A phase
    entry point drains tasks from `pop_next` (returning None ends the
    phase) and calls `on_done(task_id)` only once the task's output is
    DURABLE in the shared store — that confirmation, not the call
    returning, is what the driver's failure recovery trusts. A dying
    worker raises WorkerFailure; any other exception is a job error.
    """

    name: str
    store: StoreBackend

    @abc.abstractmethod
    def run_map_phase(self, ctx: WorkerContext,
                      pop_next: Callable[[], int | None],
                      on_done: Callable[[int], None]) -> None: ...

    @abc.abstractmethod
    def run_reduce_phase(self, ctx: WorkerContext,
                         pop_next: Callable[[], int | None],
                         on_done: Callable[[int], None]) -> None: ...

    # -- elastic-fleet extensions (optional; shuffle/elastic.py) ---------

    def last_beat(self) -> float | None:
        """Monotonic timestamp of the last sign of life, or None if this
        worker kind has no out-of-band heartbeat (in-thread workers fail
        synchronously, so the driver never needs to detect them)."""
        return None

    def fence(self) -> None:
        """Sever the worker after it is declared dead: its store view
        must refuse further requests so an in-flight laggard can never
        durably commit after the driver re-planned its claims."""


class ThreadWorker(Worker):
    """Thread-backed emulated worker with its own metrics-wrapped view of
    the shared store (per-worker request attribution in the report; the
    shared store underneath still counts the global, billed traffic)."""

    def __init__(self, name: str, store: StoreBackend, *,
                 metrics: bool = True):
        self.name = name
        self.store = MetricsMiddleware(store) if metrics else store

    # -- map: one split per task, processing sequential within the worker
    # (the working set is the split; a worker never PROCESSES more than
    # one split at a time — but the next split's chunked GETs prefetch
    # while the current one processes/spills, via the same
    # staging.prefetch pipeline the single-host path uses).

    def run_map_phase(self, ctx, pop_next, on_done):
        name = self.name
        rt.run_map_tasks(
            self.store, ctx.bucket, ctx.map_op, pop_next, plan=ctx.plan,
            timeline=ctx.timeline, control=ctx.control,
            tag_prefix=f"{name}/", on_done=on_done,
            commit_gate=(None if ctx.map_commit_gate is None
                         else (lambda g: ctx.map_commit_gate(name, g))))

    # -- reduce: the worker's own scheduler over its partition range -----

    def run_reduce_phase(self, ctx, pop_next, on_done):
        name = self.name
        rt.ReduceScheduler(
            self.store, ctx.reduce_shared,
            width=ctx.plan.parallel_reducers,
            runs_hint=ctx.num_map_tasks,
            fatal=(WorkerFailure,),
            tag_prefix=f"{name}/",
            requeue=ctx.requeue_on,
            on_requeue=(None if ctx.on_requeue is None
                        else (lambda r, e: ctx.on_requeue(name, r, e))),
            commit_gate=(None if ctx.commit_gate is None
                         else (lambda r: ctx.commit_gate(name, r))),
            # In-thread gates are cheap predicates: poll them mid-merge
            # so a speculation loser abandons instead of streaming its
            # whole partition before losing at the final gate.
            gate_poll=True,
        ).run(pop_next, on_done=on_done)


class FaultyWorker(Worker):
    """Failure-injecting wrapper — the worker-level analogue of the
    store fault middleware (io/middleware.py).

    The wrapped worker completes `fail_after_tasks` tasks (and/or its
    store view serves `fail_after_requests` requests) and then dies:
    subsequent task pops raise WorkerFailure, and the store view's kill
    switch makes every in-flight sibling request fail too — so partial
    multipart sessions and undrained spills are left behind exactly as a
    host crash would leave them, for the driver to re-execute elsewhere.
    """

    def __init__(self, inner: Worker, *, fail_after_tasks: int | None = None,
                 fail_after_requests: int | None = None):
        self.inner = inner
        self.name = inner.name
        self._kill = KillSwitchMiddleware(
            inner.store,
            exc_factory=lambda: WorkerFailure(
                f"{self.name}: store unreachable (worker dead)"),
            fail_after_requests=fail_after_requests,
        )
        # The inner worker now talks through the kill switch, so tripping
        # it severs the whole worker, not just new tasks.
        self.store = inner.store = self._kill
        self._lock = threading.Lock()
        self._remaining = fail_after_tasks

    def _gated(self, pop_next):
        def pop():
            with self._lock:
                if self._remaining is not None and self._remaining <= 0:
                    self._kill.trip()
                    raise WorkerFailure(f"{self.name}: injected worker death")
            task = pop_next()
            if task is None:
                return None
            with self._lock:
                if self._remaining is not None:
                    self._remaining -= 1
            return task
        return pop

    def run_map_phase(self, ctx, pop_next, on_done):
        self.inner.run_map_phase(ctx, self._gated(pop_next), on_done)

    def run_reduce_phase(self, ctx, pop_next, on_done):
        self.inner.run_reduce_phase(ctx, self._gated(pop_next), on_done)

    def last_beat(self) -> float | None:
        return self.inner.last_beat()

    def fence(self) -> None:
        self._kill.trip()


def build_workers(store: StoreBackend,
                  cluster: ClusterPlan) -> list[Worker]:
    """The default worker fleet: one ThreadWorker per cluster slot, each
    wrapped in FaultyWorker where the plan injects a death."""
    workers: list[Worker] = []
    for i in range(cluster.num_workers):
        wk: Worker = ThreadWorker(f"w{i}", store)
        tasks_budget = cluster.fail_after_tasks.get(i)
        reqs_budget = cluster.fail_after_requests.get(i)
        if tasks_budget is not None or reqs_budget is not None:
            wk = FaultyWorker(wk, fail_after_tasks=tasks_budget,
                              fail_after_requests=reqs_budget)
        workers.append(wk)
    return workers


class TaskPool:
    """Range-partitioned shared task queue with stealing.

    Each worker prefers its own contiguous slice (the "assigned partition
    range"); when it drains, it steals from the tail of the longest
    surviving queue — dynamic load balancing, and the mechanism that
    hands a dead worker's queued tasks to survivors without any special
    casing.
    """

    def __init__(self, tasks: Sequence[int], worker_names: Sequence[str]):
        self._lock = threading.Lock()
        self._q: dict[str, collections.deque[int]] = {
            name: collections.deque() for name in worker_names}
        names = list(worker_names)
        n, k = len(tasks), len(names)
        bounds = [round(i * n / k) for i in range(k + 1)]
        for i, name in enumerate(names):
            self._q[name].extend(tasks[bounds[i]:bounds[i + 1]])

    def popper(self, name: str) -> Callable[[], int | None]:
        def pop() -> int | None:
            with self._lock:
                own = self._q[name]
                if own:
                    return own.popleft()
                donor = max((q for q in self._q.values() if q),
                            key=len, default=None)
                if donor is not None:
                    return donor.pop()  # steal from the tail
                return None
        return pop


class PhaseDriver:
    """Run phases of tasks over a worker fleet with failure recovery.

    Tasks run in barriered phases (every reduce partition needs every
    map task's spilled run, so the barrier is inherent to the dataflow,
    not a scheduling choice). Within a phase the driver runs ROUNDS: it
    launches every surviving worker on the pending task pool, joins
    them, marks workers that raised WorkerFailure as dead, and re-runs
    the phase with whatever tasks were never durably confirmed — the
    re-executed tasks the report counts. A real (non-WorkerFailure)
    exception anywhere cancels the job and re-raises.
    """

    def __init__(self, workers: Sequence[Worker], *, tracer=None):
        self.workers = list(workers)
        self.tracer = tracer  # obs Tracer: rounds, deaths, re-executions
        self._lock = threading.Lock()
        self._dead: set[str] = set()
        self.failed_workers: list[str] = []
        self.per_worker_tasks: dict[str, int] = {}

    def _drive(self, worker: Worker, entry: Callable[[Worker], None],
               control: rt.JobControl) -> None:
        # Worker threads start context-free (ContextVars don't cross
        # threads): seed the job/worker identity so task contexts built
        # inside the phase bodies inherit the right job name.
        ctx = None
        if self.tracer is not None:
            ctx = TraceContext(job=self.tracer.job, worker=worker.name)
        try:
            with use_context(ctx):
                entry(worker)
        except WorkerFailure:
            with self._lock:
                if worker.name not in self._dead:
                    self._dead.add(worker.name)
                    self.failed_workers.append(worker.name)
                    if self.tracer is not None:
                        self.tracer.instant(
                            "cluster.worker_dead",
                            ctx=TraceContext(job=self.tracer.job,
                                             worker=worker.name))
                        self.tracer.registry.counter("cluster.workers_dead")
        except BaseException as e:
            control.fail(e)

    def run_phase(self, phase: str, tasks: Sequence[int],
                  entry: Callable[[Worker, Callable, Callable], None],
                  control: rt.JobControl) -> int:
        """Run `tasks` to durable completion; returns re-executions."""
        done: set[int] = set()
        done_lock = threading.Lock()
        pending = list(tasks)
        reexecuted = 0
        first_round = True
        while pending:
            with self._lock:
                alive = [wk for wk in self.workers
                         if wk.name not in self._dead]
            if not alive:
                raise ClusterFailure(
                    f"all {len(self.workers)} workers dead during {phase} "
                    f"phase with {len(pending)} tasks unfinished")
            if not first_round:
                reexecuted += len(pending)
                if self.tracer is not None:
                    self.tracer.registry.counter(
                        "cluster.tasks_reexecuted", len(pending), phase=phase)
            if self.tracer is not None:
                self.tracer.instant(
                    "cluster.round", phase=phase,
                    first=first_round, pending=len(pending),
                    alive=len(alive))
            first_round = False
            pool = TaskPool(pending, [wk.name for wk in alive])

            def on_done_for(wk: Worker):
                def on_done(task: int) -> None:
                    with done_lock:
                        done.add(task)
                        self.per_worker_tasks[wk.name] = (
                            self.per_worker_tasks.get(wk.name, 0) + 1)
                return on_done

            threads = [
                threading.Thread(
                    target=self._drive,
                    args=(wk, lambda w, p=pool.popper(wk.name),
                          d=on_done_for(wk): entry(w, p, d), control),
                    name=f"cluster-{wk.name}-{phase}")
                for wk in alive
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            control.raise_first()
            with done_lock:
                pending = [t for t in tasks if t not in done]
        return reexecuted

    def per_worker_stats(self) -> dict:
        return {
            wk.name: wk.store.stats_snapshot()
            for wk in self.workers
            if hasattr(wk.store, "stats_snapshot")
        }


__all__ = [
    "ClusterFailure",
    "ClusterPlan",
    "FaultyWorker",
    "PhaseDriver",
    "TaskPool",
    "ThreadWorker",
    "Worker",
    "WorkerContext",
    "WorkerFailure",
    "build_workers",
]
