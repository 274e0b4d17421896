"""Elastic fleet driver: membership, heartbeats, speculation, spill loss.

The static PhaseDriver (shuffle/executor.py) runs barriered ROUNDS over
a fixed worker list: deaths are only observed when a phase round joins,
re-execution waits for the round barrier, and a "dead" worker's spill
runs conveniently survive in the shared store. This module is the
elastic replacement the paper's §2.6 story actually needs:

  * **Membership** — workers join (`admit`) and leave (`retire`)
    mid-phase; a heartbeat monitor declares silent workers dead
    (`cluster.heartbeat_miss`) without waiting for them to fail a
    store request.
  * **Claims, not ranges** — `ClaimPool` replaces the range-partitioned
    TaskPool: workers pull claims from one shared pool, a dead worker's
    unconfirmed claims are released immediately (survivors pick them up
    inside the SAME phase, no round barrier), and duplicate claims are
    legal.
  * **Speculation** — once enough task durations are observed, an idle
    worker may duplicate an in-flight laggard that has run past a
    quantile deadline (`cluster.speculate`). First durable multipart
    commit wins: `ClaimPool.confirm` is the dedup point and
    `ClaimPool.may_commit` is the loser-abort gate consulted by
    runtime.finalize_session immediately before CompleteMultipartUpload.
    Both outcomes are byte-identical because spill/output bytes are
    deterministic functions of (task, plan, input).
  * **Correlated spill loss** — a dying worker takes its local spill
    tier with it (`FleetPlan.lose_spill_on_death`): the driver deletes
    the spill runs of every map task the dead worker had confirmed
    (lineage via `MapOp.spill_keys`), unconfirms those map tasks, parks
    reduce partitions that can no longer read their inputs
    (`cluster.spill_lost`), re-runs the lost map waves on survivors,
    and only then resumes the reduce phase. In-flight reducers that
    trip over a vanished run raise ObjectNotFound, which the scheduler
    routes back here as a requeue instead of a job failure.

Everything rides the existing durability contract: `on_done` fires only
after a multipart COMMIT, commits are atomic + idempotent, and spill
bytes depend only on (task id, plan, input) — so output stays
byte/etag-identical under kills, scale-up/down, stragglers, and loss.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Sequence

from repro_torch.io.backends import ObjectNotFound
from repro_torch.obs.context import TraceContext, use_context

from repro_torch.shuffle.api import require
from repro_torch.shuffle.executor import (ClusterFailure, Worker, WorkerContext,
                                    WorkerFailure)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Elastic-fleet policy knobs (the cluster analogue of ShufflePlan).

    `heartbeat_timeout_s` is how long a worker may stay silent before
    the monitor declares it dead; workers whose `last_beat()` is None
    (plain ThreadWorkers) are exempt — they fail synchronously instead.
    Speculation fires only after `speculation_min_samples` confirmed
    durations: a task is a laggard once its oldest live claim is older
    than max(quantile(durations) * speculation_factor, speculation_min_s).
    """

    heartbeat_timeout_s: float = 2.0
    monitor_interval_s: float = 0.05
    speculation: bool = False
    speculation_quantile: float = 0.5
    speculation_factor: float = 2.0
    speculation_min_s: float = 0.2
    speculation_min_samples: int = 3
    max_duplicates: int = 2
    lose_spill_on_death: bool = True

    def __post_init__(self):
        require(self.heartbeat_timeout_s > 0, "heartbeat_timeout_s",
                self.heartbeat_timeout_s, "must be positive seconds")
        require(self.monitor_interval_s > 0, "monitor_interval_s",
                self.monitor_interval_s, "must be positive seconds")
        require(0.0 <= self.speculation_quantile <= 1.0,
                "speculation_quantile", self.speculation_quantile,
                "is a quantile in [0, 1]")
        require(self.speculation_factor >= 1.0, "speculation_factor",
                self.speculation_factor,
                "< 1 would speculate on on-pace tasks")
        require(self.speculation_min_samples >= 1, "speculation_min_samples",
                self.speculation_min_samples, "needs >= 1 observed duration")
        require(self.max_duplicates >= 2, "max_duplicates",
                self.max_duplicates,
                "must allow the original plus >= 1 duplicate")


class ClaimPool:
    """Shared task pool with claims, releases, speculation, and parking.

    States of a task: *pending* (in the deque), *claimed* (>= 1 live
    in-flight attempts), *blocked* (parked until lost lineage is
    regenerated), *confirmed* (a durable commit landed — terminal).
    `pop` blocks while nothing is servable but progress elsewhere could
    still create work for this worker (a death releasing claims, a
    laggard crossing the speculation deadline); it returns None — ending
    the worker's phase — only when every unconfirmed task is blocked,
    the job is cancelled, or the worker itself retired.
    """

    def __init__(self, tasks: Sequence[int], *, plan: FleetPlan,
                 phase: str, tracer=None, cancel=None,
                 clock: Callable[[], float] = time.monotonic):
        self._tasks = list(tasks)
        self._plan = plan
        self._phase = phase
        self._tracer = tracer
        self._cancel = cancel  # threading.Event: job-wide cancellation
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: collections.deque[int] = collections.deque(tasks)
        self._claims: dict[int, list[str]] = {}  # live in-flight claimants
        self._started: dict[int, float] = {}  # oldest live claim's start
        self._first_claimant: dict[int, str] = {}
        self._ever_claimed: set[int] = set()
        self._speculated_tasks: set[int] = set()
        self._confirmed: dict[int, str] = {}  # task -> winning worker
        self._blocked: set[int] = set()
        self._dead: set[str] = set()
        self._retired: set[str] = set()
        # Confirmed attempt durations, feeding the speculation deadline.
        self._durations: list[float] = []
        # Counters (read under the cond lock via snapshot()):
        self.reexecutions = 0  # claims of previously-claimed tasks
        self.speculated = 0  # duplicate attempts launched
        self.spec_wins = 0  # confirmed by a non-first claimant
        self.spec_losses = 0  # attempts beaten to the commit

    # -- worker-facing ----------------------------------------------------

    def popper(self, worker: str, *,
               yield_when_busy: bool = False) -> Callable[[], int | None]:
        return lambda: self.pop(worker, yield_when_busy=yield_when_busy)

    def pop(self, worker: str, *, yield_when_busy: bool = False) -> int | None:
        """Claim the next task. `yield_when_busy` is for pull-ahead
        callers (the map pipeline's prefetch fill loop runs on the same
        thread that PROCESSES tasks): instead of blocking while the
        worker still holds unconfirmed claims, return None so the caller
        drains its in-flight work — blocking there would deadlock the
        whole fleet at the queue tail. The phase driver relaunches the
        worker, and a relaunched idle worker blocks here safely."""
        with self._cond:
            while True:
                if worker in self._dead:
                    raise WorkerFailure(
                        f"{worker}: fenced (declared dead by the driver)")
                if self._cancel is not None and self._cancel.is_set():
                    return None
                if worker in self._retired:
                    return None
                if self.all_confirmed():
                    return None
                task = self._claim_pending(worker)
                if task is None:
                    task = self._claim_speculative(worker)
                if task is not None:
                    return task
                if not self._servable_later():
                    return None  # everything left is parked on recovery
                if yield_when_busy and self._worker_inflight(worker):
                    return None
                self._cond.wait(0.05)

    def confirm(self, task: int, worker: str) -> bool:
        """Record a durable commit; False means another attempt won."""
        with self._cond:
            if task in self._confirmed:
                if task in self._speculated_tasks:
                    self.spec_losses += 1
                return False
            self._confirmed[task] = worker
            self._blocked.discard(task)  # a straggler attempt may land
            started = self._started.pop(task, None)
            if started is not None:
                self._durations.append(self._clock() - started)
            if (task in self._speculated_tasks
                    and self._first_claimant.get(task) != worker):
                self.spec_wins += 1
            self._cond.notify_all()
            return True

    def may_commit(self, task: int, worker: str) -> bool:
        """The loser-abort gate: False once another attempt committed."""
        with self._cond:
            owner = self._confirmed.get(task)
            return owner is None or owner == worker

    # -- driver-facing ----------------------------------------------------

    def release_worker(self, worker: str) -> list[int]:
        """Declare `worker` dead: drop its claims and re-pend tasks with
        no surviving live attempt (front of the queue — recovery work
        beats fresh work). Its next pop raises WorkerFailure."""
        freed = []
        with self._cond:
            self._dead.add(worker)
            for task, claims in self._claims.items():
                if worker not in claims:
                    continue
                claims[:] = [c for c in claims if c != worker]
                if (not claims and task not in self._confirmed
                        and task not in self._blocked
                        and task not in self._pending):
                    self._pending.appendleft(task)
                    self._started.pop(task, None)
                    freed.append(task)
            self._cond.notify_all()
        return freed

    def retire_worker(self, worker: str) -> None:
        """Graceful drain: the worker keeps its in-flight attempts but is
        handed no further tasks."""
        with self._cond:
            self._retired.add(worker)
            self._cond.notify_all()

    def release_claim(self, task: int, worker: str, *,
                      block: bool) -> None:
        """An attempt aborted cleanly (requeue): drop the claim, and
        either park the task (its input is gone until recovery) or
        re-pend it immediately."""
        with self._cond:
            claims = self._claims.get(task)
            if claims and worker in claims:
                claims.remove(worker)
            if task in self._confirmed:
                return
            if block:
                self._blocked.add(task)
                self._started.pop(task, None)
            elif (not (claims or []) and task not in self._pending
                    and task not in self._blocked):
                self._pending.appendleft(task)
                self._started.pop(task, None)
            self._cond.notify_all()

    def block_unconfirmed(self) -> int:
        """Park every unconfirmed task (correlated input loss: nothing
        can safely start until the lineage is regenerated)."""
        with self._cond:
            n = 0
            for task in self._tasks:
                if task not in self._confirmed and task not in self._blocked:
                    self._blocked.add(task)
                    n += 1
            self._pending.clear()
            self._cond.notify_all()
            return n

    def unblock_all(self) -> int:
        """Recovery finished: re-pend parked tasks without live claims
        (a parked task whose old attempt is still running keeps it —
        that attempt either commits or requeues)."""
        with self._cond:
            n = 0
            for task in sorted(self._blocked):
                if task in self._confirmed or task in self._pending:
                    continue
                if self._claims.get(task):
                    continue
                self._pending.append(task)
                n += 1
            self._blocked.clear()
            self._cond.notify_all()
            return n

    def unconfirm(self, tasks: Sequence[int]) -> list[int]:
        """Roll back confirmations whose durable OUTPUT was destroyed
        (spill-tier loss): those tasks must run again."""
        rolled = []
        with self._cond:
            for task in tasks:
                if self._confirmed.pop(task, None) is None:
                    continue
                self._claims.pop(task, None)
                self._started.pop(task, None)
                if task not in self._pending:
                    self._pending.append(task)
                rolled.append(task)
            self._cond.notify_all()
        return rolled

    # -- introspection ----------------------------------------------------

    def all_confirmed(self) -> bool:
        return len(self._confirmed) == len(self._tasks)

    def servable(self) -> bool:
        """Could a (re)launched worker still find or wait for work here?
        False once everything unconfirmed is parked on recovery — the
        phase should wind down and let the driver regenerate lineage."""
        with self._cond:
            return self._servable_later()

    def unconfirmed(self) -> list[int]:
        with self._cond:
            return [t for t in self._tasks if t not in self._confirmed]

    def blocked(self) -> set[int]:
        with self._cond:
            return set(self._blocked)

    def confirmed_by(self, worker: str) -> list[int]:
        with self._cond:
            return [t for t, w in self._confirmed.items() if w == worker]

    # -- internals (self._cond held) --------------------------------------

    def _worker_inflight(self, worker: str) -> bool:
        return any(worker in claims and task not in self._confirmed
                   for task, claims in self._claims.items())

    def _servable_later(self) -> bool:
        """Could waiting produce work for SOME worker? True while any
        unconfirmed task is unblocked: it is pending, or in flight (a
        death may release it; a laggard may cross the speculation
        deadline). Once everything left is parked (blocked), only the
        driver's recovery pass can make progress — pops return None."""
        return any(t not in self._confirmed and t not in self._blocked
                   for t in self._tasks)

    def _claim_pending(self, worker: str) -> int | None:
        while self._pending:
            task = self._pending.popleft()
            if task in self._confirmed or task in self._blocked:
                continue
            claims = self._claims.setdefault(task, [])
            if not claims:
                self._started[task] = self._clock()
            claims.append(worker)
            self._first_claimant.setdefault(task, worker)
            if task in self._ever_claimed:
                self.reexecutions += 1
            self._ever_claimed.add(task)
            return task
        return None

    def _claim_speculative(self, worker: str) -> int | None:
        plan = self._plan
        if not plan.speculation:
            return None
        if len(self._durations) < plan.speculation_min_samples:
            return None
        ordered = sorted(self._durations)
        idx = min(int(len(ordered) * plan.speculation_quantile),
                  len(ordered) - 1)
        deadline = max(ordered[idx] * plan.speculation_factor,
                       plan.speculation_min_s)
        now = self._clock()
        for task in self._tasks:
            if task in self._confirmed or task in self._blocked:
                continue
            claims = self._claims.get(task)
            if not claims or worker in claims:
                continue
            live = [c for c in claims if c not in self._dead]
            if not live or len(live) >= plan.max_duplicates:
                continue
            started = self._started.get(task)
            if started is None or now - started <= deadline:
                continue
            claims.append(worker)
            self.speculated += 1
            self._speculated_tasks.add(task)
            self._ever_claimed.add(task)
            if self._tracer is not None:
                self._tracer.instant(
                    "cluster.speculate", phase=self._phase, task=task,
                    worker=worker, laggards=live,
                    waited_s=round(now - started, 4),
                    deadline_s=round(deadline, 4))
                self._tracer.registry.counter("cluster.tasks_speculated",
                                              phase=self._phase)
            return task
        return None


class ElasticPhaseDriver:
    """Drives an elastic fleet through map + reduce with live recovery.

    Differences from executor.PhaseDriver: no rounds (releases happen
    inside the phase), a heartbeat monitor, mid-phase admission /
    retirement, speculation via ClaimPool, and correlated spill-tier
    loss with lineage-tracked map re-execution.
    """

    def __init__(self, workers: Sequence[Worker], *, fleet: FleetPlan,
                 store, bucket: str, tracer=None):
        require(len(list(workers)) >= 1, "workers", len(list(workers)),
                "an elastic fleet still needs an initial worker")
        self.workers: list[Worker] = list(workers)
        self.fleet = fleet
        self.store = store  # the SHARED store: spill loss is driver-side
        self.bucket = bucket
        self.tracer = tracer
        self._lock = threading.Lock()
        self._dead: set[str] = set()
        self._retired: set[str] = set()
        self.failed_workers: list[str] = []
        self.per_worker_tasks: dict[str, int] = {}
        self._requeues_by_task: dict[int, int] = {}
        self.heartbeat_misses = 0
        self.spill_lost_map_tasks = 0
        self.requeued_reduce_tasks = 0
        self.workers_admitted = 0
        self.workers_retired = 0
        self.recovery_rounds = 0
        self.map_seconds = 0.0
        self.reduce_seconds = 0.0
        self._map_pool: ClaimPool | None = None
        self._reduce_pool: ClaimPool | None = None
        self._active_pool: ClaimPool | None = None
        self._ctx: WorkerContext | None = None

    # -- membership -------------------------------------------------------

    def admit(self, worker: Worker) -> None:
        """Join a worker mid-job: the running phase launches it as soon
        as its launcher loop next looks (<= ~50 ms)."""
        with self._lock:
            self.workers.append(worker)
            self.workers_admitted += 1
        if self.tracer is not None:
            self.tracer.instant("cluster.worker_admitted", worker=worker.name)
            self.tracer.registry.counter("cluster.workers_admitted")

    def retire(self, name: str) -> None:
        """Gracefully drain a worker: it finishes in-flight claims, is
        handed nothing new, and skips future phases."""
        with self._lock:
            self._retired.add(name)
            self.workers_retired += 1
            pool = self._active_pool
        if pool is not None:
            pool.retire_worker(name)
        if self.tracer is not None:
            self.tracer.instant("cluster.worker_retired", worker=name)
            self.tracer.registry.counter("cluster.workers_retired")

    def _alive(self) -> list[Worker]:
        with self._lock:
            return [wk for wk in self.workers
                    if wk.name not in self._dead
                    and wk.name not in self._retired]

    # -- the job ----------------------------------------------------------

    def run_job(self, ctx: WorkerContext, *, num_map_tasks: int,
                num_partitions: int) -> None:
        """Map to full confirmation, then reduce — re-running lost map
        lineage between reduce attempts until every partition commits."""
        fleet = self.fleet
        self._ctx = ctx
        map_pool = ClaimPool(range(num_map_tasks), plan=fleet, phase="map",
                             tracer=self.tracer, cancel=ctx.control.cancel)
        reduce_pool = ClaimPool(range(num_partitions), plan=fleet,
                                phase="reduce", tracer=self.tracer,
                                cancel=ctx.control.cancel)
        self._map_pool, self._reduce_pool = map_pool, reduce_pool
        # Speculation loser-abort gates, one per phase. The context's
        # gate convention is (worker, task) — the pool's is
        # (task, worker), so adapt explicitly; the same predicate is
        # both the commit-time refusal and the mid-attempt abandonment
        # poll (reduce merge windows, map chunk fetches). Plus the
        # lost-input requeue route (ObjectNotFound = a spill run this
        # driver deleted out from under an in-flight merge).
        ctx.commit_gate = lambda worker, r: reduce_pool.may_commit(r, worker)
        ctx.map_commit_gate = lambda worker, g: map_pool.may_commit(g, worker)
        ctx.requeue_on = (ObjectNotFound,)
        ctx.on_requeue = self._on_requeue

        def map_entry(wk, pop, done):
            wk.run_map_phase(ctx, pop, done)

        def reduce_entry(wk, pop, done):
            wk.run_reduce_phase(ctx, pop, done)

        t0 = time.perf_counter()
        self._phase_to_completion("map", map_pool, map_entry, ctx.control)
        self.map_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        while True:
            self._run_phase("reduce", reduce_pool, reduce_entry, ctx.control)
            if reduce_pool.all_confirmed():
                break
            self._require_alive("reduce", reduce_pool)
            # Partitions are parked on lost map lineage: regenerate the
            # missing spill runs (deterministic bytes — the re-executed
            # wave rewrites exactly what was lost), then resume.
            if not map_pool.all_confirmed():
                self.recovery_rounds += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "cluster.round", phase="map-recovery",
                        pending=len(map_pool.unconfirmed()),
                        alive=len(self._alive()))
                self._phase_to_completion("map", map_pool, map_entry,
                                          ctx.control)
            if not reduce_pool.unblock_all() and not reduce_pool.blocked():
                # No parked work was released and nothing is parked:
                # the phase ended with unconfirmed, unblocked tasks —
                # only possible when the fleet died under it.
                self._require_alive("reduce", reduce_pool)
        self.reduce_seconds = time.perf_counter() - t0

    def per_worker_stats(self) -> dict:
        return {
            wk.name: wk.store.stats_snapshot()
            for wk in self.workers
            if hasattr(wk.store, "stats_snapshot")
        }

    def pool_counters(self) -> dict:
        mp_, rp = self._map_pool, self._reduce_pool
        return {
            "reexecuted_map_tasks": mp_.reexecutions if mp_ else 0,
            "reexecuted_reduce_tasks": rp.reexecutions if rp else 0,
            "speculated_tasks": ((mp_.speculated if mp_ else 0)
                                 + (rp.speculated if rp else 0)),
            "speculation_wins": ((mp_.spec_wins if mp_ else 0)
                                 + (rp.spec_wins if rp else 0)),
        }

    # -- phase machinery --------------------------------------------------

    def _phase_to_completion(self, phase, pool, entry, control):
        while not pool.all_confirmed():
            self._require_alive(phase, pool)
            self._run_phase(phase, pool, entry, control)
            control.raise_first()

    def _require_alive(self, phase, pool):
        if not self._alive():
            raise ClusterFailure(
                f"all {len(self.workers)} workers dead during {phase} "
                f"phase with {len(pool.unconfirmed())} tasks unfinished")

    def _run_phase(self, phase, pool, entry, control):
        """One pass: launch every eligible worker (including ones
        admitted while the phase runs), monitor heartbeats, join all.

        Workers are RELAUNCHED within the pass: a map entry legitimately
        returns while the phase is still open — its yield-when-busy pops
        hand back None whenever the worker holds unconfirmed in-flight
        claims, so it drains a wave and exits (see ClaimPool.pop). If
        the driver only relaunched between passes, every fast worker
        would sit out the straggler's tail: an idle worker must be BACK
        in the pool, blocked in pop, for the speculation deadline to
        ever hand it a duplicate of the laggard's task. Relaunch happens
        while unparked unconfirmed work remains; once everything left is
        blocked on recovery (or the job is cancelled/complete), exited
        workers stay down and the pass winds up."""
        with self._lock:
            self._active_pool = pool
        stop = threading.Event()
        spawned: list[threading.Thread] = []
        current: dict[str, threading.Thread] = {}

        def launch(wk: Worker) -> None:
            t = threading.Thread(
                target=self._drive, args=(wk, phase, pool, entry, control),
                name=f"elastic-{wk.name}-{phase}")
            spawned.append(t)
            current[wk.name] = t
            t.start()

        monitor = threading.Thread(
            target=self._monitor, args=(pool, stop),
            name=f"elastic-monitor-{phase}", daemon=True)
        monitor.start()
        try:
            for wk in self._alive():
                launch(wk)
            while True:
                for t in list(current.values()):
                    t.join(timeout=0.02)
                launches = []
                if (not pool.all_confirmed() and pool.servable()
                        and not control.cancel.is_set()):
                    launches = [wk for wk in self._alive()
                                if not current.get(wk.name)
                                or not current[wk.name].is_alive()]
                for wk in launches:
                    launch(wk)
                if not launches and all(not t.is_alive()
                                        for t in current.values()):
                    break
        finally:
            stop.set()
            monitor.join()
            for t in spawned:
                t.join()
            with self._lock:
                self._active_pool = None
        control.raise_first()

    def _drive(self, wk, phase, pool, entry, control):
        ctx = None
        if self.tracer is not None:
            ctx = TraceContext(job=self.tracer.job, worker=wk.name)

        def on_done(task: int) -> None:
            if pool.confirm(task, wk.name):
                with self._lock:
                    self.per_worker_tasks[wk.name] = (
                        self.per_worker_tasks.get(wk.name, 0) + 1)

        # Map entries pull tasks from inside the prefetch pipeline on the
        # processing thread itself, so their pops must never block while
        # the worker holds in-flight claims (see ClaimPool.pop); reduce
        # schedulers pop from dedicated threads and can block freely.
        pop = pool.popper(wk.name, yield_when_busy=(phase == "map"))
        try:
            with use_context(ctx):
                entry(wk, pop, on_done)
        except WorkerFailure:
            self._on_worker_death(wk, pool, reason="failure")
        except BaseException as e:
            control.fail(e)

    # -- failure handling -------------------------------------------------

    def _monitor(self, pool, stop):
        timeout = self.fleet.heartbeat_timeout_s
        while not stop.wait(self.fleet.monitor_interval_s):
            now = time.monotonic()
            for wk in self._alive():
                beat = wk.last_beat()
                if beat is None or now - beat <= timeout:
                    continue
                with self._lock:
                    self.heartbeat_misses += 1
                if self.tracer is not None:
                    self.tracer.instant(
                        "cluster.heartbeat_miss", worker=wk.name,
                        silent_s=round(now - beat, 3))
                    self.tracer.registry.counter("cluster.heartbeat_misses")
                self._on_worker_death(wk, pool, reason="heartbeat")

    def _on_worker_death(self, wk, pool, *, reason):
        with self._lock:
            if wk.name in self._dead:
                return
            self._dead.add(wk.name)
            self.failed_workers.append(wk.name)
        if self.tracer is not None:
            self.tracer.instant(
                "cluster.worker_dead", reason=reason,
                ctx=TraceContext(job=self.tracer.job, worker=wk.name))
            self.tracer.registry.counter("cluster.workers_dead")
        try:
            wk.fence()  # sever the store view / kill the process
        except BaseException:
            pass
        pool.release_worker(wk.name)
        # Release in BOTH pools: a death during reduce must also fence
        # the worker out of any later map-recovery pass.
        for other in (self._map_pool, self._reduce_pool):
            if other is not None and other is not pool:
                other.release_worker(wk.name)
        if self.fleet.lose_spill_on_death:
            self._lose_spill_tier(wk.name)

    def _lose_spill_tier(self, name: str) -> None:
        """The dead worker's local spill tier dies with it: destroy the
        runs of every map task it had confirmed, roll those tasks back,
        and park reduce partitions until the lineage is regenerated.

        Ordering matters in both phases. While REDUCE is live, park the
        reducers and roll the map confirmations back BEFORE deleting:
        the instant a surviving merge trips over a deleted run, the
        requeue must already look recoverable (map not all confirmed),
        or the job would mistake the injected loss for real data loss.
        While MAP is live the hazard inverts: rolling back first would
        re-pend the task, and a fast survivor could re-spill a run
        concurrently with our deletes — destroying the FRESH copy with
        the task marked confirmed. No reducer reads during map, so
        delete-then-unconfirm is safe there."""
        map_pool, reduce_pool = self._map_pool, self._reduce_pool
        if map_pool is None or self._ctx is None:
            return
        owned = map_pool.confirmed_by(name)
        if not owned:
            return
        lost_keys = []
        for task in owned:
            lost_keys.extend(self._ctx.map_op.spill_keys(task))
        with self._lock:
            reduce_live = self._active_pool is reduce_pool

        def destroy() -> int:
            deleted = 0
            for key in lost_keys:
                try:
                    self.store.delete(self.bucket, key)
                    deleted += 1
                except KeyError:  # ObjectNotFound: never drained, or raced
                    pass
            return deleted

        if reduce_live:
            reduce_pool.block_unconfirmed()
            rolled = map_pool.unconfirm(owned)
            deleted = destroy()
        else:
            deleted = destroy()
            rolled = map_pool.unconfirm(owned)
        with self._lock:
            self.spill_lost_map_tasks += len(rolled)
        if self.tracer is not None:
            self.tracer.instant(
                "cluster.spill_lost", worker=name, map_tasks=len(rolled),
                objects=deleted)
            self.tracer.registry.counter("cluster.spill_lost_tasks",
                                         len(rolled))

    # A reduce task may legitimately requeue a few times (loss, recovery,
    # a second loss); past this budget the missing input is not an
    # injected spill loss but real, unrecoverable data loss.
    MAX_REQUEUES_PER_TASK = 8

    def _on_requeue(self, worker: str, task: int, exc: BaseException) -> bool:
        """A reduce attempt hit ObjectNotFound mid-merge. Recoverable iff
        spill loss is actually in play — otherwise the store really lost
        data and the job must fail."""
        map_pool, reduce_pool = self._map_pool, self._reduce_pool
        if map_pool is None or reduce_pool is None:
            return False
        with self._lock:
            n = self._requeues_by_task[task] = (
                self._requeues_by_task.get(task, 0) + 1)
            loss_seen = self.spill_lost_map_tasks > 0
        plausible = (not map_pool.all_confirmed() or reduce_pool.blocked()
                     or loss_seen)
        if not plausible or n > self.MAX_REQUEUES_PER_TASK:
            return False
        reduce_pool.release_claim(task, worker, block=True)
        with self._lock:
            self.requeued_reduce_tasks += 1
        if self.tracer is not None:
            self.tracer.instant("cluster.reduce_requeued", worker=worker,
                                task=task, error=type(exc).__name__)
        return True


__all__ = ["ClaimPool", "ElasticPhaseDriver", "FleetPlan"]
