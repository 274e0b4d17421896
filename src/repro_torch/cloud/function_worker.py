"""Serverless execution: one task per invocation, no state but the store.

Port of src/repro/cloud/function_worker.py: an invocation event carries
`num_workers` (the sort's W, a batch axis) and `device` where the
reference's carries `mesh_devices` and `axis`; `event_from_reference`
converts a reference event, so one JSON event can drive both `invoke`s.

The library's thesis (paper §2.6, Exoshuffle's portability claim) is
that shuffle-as-a-library runs on whatever execution substrate the
application already has, because everything recovery needs lives in the
store: spill offsets ride in object metadata, commits are atomic +
idempotent multipart completes, and output bytes are deterministic
functions of (task, plan, input). This module cashes that claim in on
the most hostile substrate there is — a FaaS platform where an executor
is *one function invocation*: no warm process to heartbeat, no local
spill tier, no shared offsets dict, a hard memory bound, and a billing
meter that charges GB-seconds per invocation.

Three pieces:

  * `invoke(event)` — the function handler. A single JSON event (the
    Lambda payload) carries everything: store endpoint, bucket, plan,
    phase, ONE task id, memory limit. The handler rebuilds its world
    from the event alone — à la shuffle/worker_main's subprocess spec —
    runs exactly that task, and returns a JSON-able result with the
    billed duration, measured peak memory, and per-invocation
    (retry-inflated) request counts. Reduce-side run offsets are
    re-read from spill-object metadata on every invocation; nothing
    survives between calls except what the store holds.
  * `FunctionWorker` — the unchanged `Worker` protocol over a loop of
    invocations, so the existing ElasticPhaseDriver/ClaimPool drive the
    fleet: durable-multipart-commit recovery, speculation loser-abort
    gates, and byte/etag-identity all transfer with ZERO new recovery
    code. The driver's gates/requeue hooks are passed to `invoke` as
    the out-of-band control plane (on a real platform: a claim table
    the function consults before CompleteMultipartUpload).
  * `InvocationDriver` — convenience front end building the fleet and
    running the sort job, plus the per-invocation accounting feeding
    core/cost_model's GB-second pricing leg.

Emulation honesty notes. A "container" (the memo below) models FaaS
warm starts: per (worker, job-config) we keep exactly the state a real
platform keeps between invocations of one sandbox — the loaded runtime,
here the per-instance sorter, whose first sort on a card loads the
kernels — and nothing correctness-relevant; cold starts are modeled as
injectable latency (`cold_start_s`) charged to the first invocation of
each worker's sandbox, excluded from the billed duration (Lambda does
not bill managed cold-start init). All in-process invocations share
this host's card, so map compute serializes on a module lock exactly
as the thread fleet serializes on its shared WaveSorter lock; a real
deployment gives every function its own runtime, making the map phase
embarrassingly parallel — which is the point of the sweep in the
reference's benchmarks/bench_serverless.py.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
import weakref
from typing import Callable, Mapping

from repro_torch.io.backends import ObjectNotFound, StoreStats
from repro_torch.io.middleware import KillSwitchMiddleware, MetricsMiddleware
from repro_torch.shuffle.executor import Worker, WorkerFailure


def _require(cond: bool, knob: str, value, why: str) -> None:
    if not cond:
        raise ValueError(f"{knob}={value!r}: {why}")


# ---------------------------------------------------------------------------
# Endpoint registry: the in-process stand-in for a store endpoint URL
# ---------------------------------------------------------------------------

# Token -> live store object. A real event names an endpoint + creds;
# in-process the event carries an opaque token resolved here. Weak so a
# finished job's store doesn't outlive its owner.
_ENDPOINTS: "weakref.WeakValueDictionary[str, object]" = (
    weakref.WeakValueDictionary())
_ENDPOINT_LOCK = threading.Lock()
_ENDPOINT_SEQ = 0


def register_endpoint(store) -> str:
    """Register a live store object; returns the token an invocation
    event's store spec (`{"kind": "endpoint", "token": ...}`) resolves."""
    global _ENDPOINT_SEQ
    with _ENDPOINT_LOCK:
        _ENDPOINT_SEQ += 1
        token = f"ep-{_ENDPOINT_SEQ}"
        _ENDPOINTS[token] = store
    return token


def _resolve_store(spec: dict):
    kind = spec.get("kind")
    if kind == "endpoint":
        store = _ENDPOINTS.get(spec.get("token", ""))
        if store is None:
            raise ValueError(
                f"store={spec!r}: endpoint token is not registered in this "
                "process (register_endpoint the live store first)")
        return store
    if kind in ("fs", "tiered"):
        # Real deployments rebuild a store from config, exactly like the
        # subprocess worker; reuse its builder (metrics included).
        from repro_torch.shuffle.worker_main import _build_store
        return _build_store(spec)
    raise ValueError(
        f"store={spec!r}: unknown store spec kind (expected endpoint, fs, "
        "or tiered)")


# ---------------------------------------------------------------------------
# Warm containers + the shared-host device lock
# ---------------------------------------------------------------------------

# Container memo: (worker, job-config JSON) -> the map-side SortMapOp,
# whose per-instance sorter is the expensive thing a warm sandbox
# amortizes. Per-WORKER key: real sandboxes are never shared across
# concurrent executors, so neither is this state (and each worker's
# phase loop is serial, so no locking beyond the dict's).
_CONTAINERS: dict[str, object] = {}
_CONTAINER_LOCK = threading.Lock()
_CONTAINER_CAP = 32

# Every in-process invocation shares ONE card; serialize the
# device legs like the thread fleet's shared WaveSorter lock does.
_DEVICE_LOCK = threading.Lock()


def _container_key(event: dict) -> str:
    cfg = {k: event.get(k) for k in
           ("worker", "bucket", "plan", "num_workers", "device",
            "boundaries", "store")}
    return json.dumps(cfg, sort_keys=True)


def _map_op_for(event: dict):
    """The warm-start memo: reuse the worker-sandbox's warm sorter
    across map invocations; build (and cache) on a cold start."""
    from repro_torch.shuffle.sort import SortMapOp

    key = _container_key(event)
    with _CONTAINER_LOCK:
        op = _CONTAINERS.get(key)
    if op is not None:
        return op
    bounds = event.get("boundaries")
    op = SortMapOp(_plan_from(event), int(event["num_workers"]),
                   boundaries=None if bounds is None else bounds,
                   device=event["device"])
    with _CONTAINER_LOCK:
        if len(_CONTAINERS) >= _CONTAINER_CAP:
            _CONTAINERS.clear()  # platform reaped idle sandboxes
        _CONTAINERS[key] = op
    return op


def _plan_from(event: dict):
    from repro_torch.core.external_sort import ExternalSortPlan
    return ExternalSortPlan(**event["plan"])


def event_from_reference(event: dict, *, device="cuda") -> dict:
    """The port's event for a reference package's invocation event: the
    mesh's device count becomes `num_workers`, `device` is where this
    invocation sorts, and the plan's impl maps as
    core/external_sort.plan_from_reference maps it."""
    from repro_torch.core.external_sort import plan_from_reference

    out = {k: v for k, v in event.items()
           if k not in ("mesh_devices", "axis")}
    out["num_workers"] = int(event["mesh_devices"])
    out["device"] = str(device)
    out["plan"] = dataclasses.asdict(plan_from_reference(event["plan"]))
    return json.loads(json.dumps(out))


# ---------------------------------------------------------------------------
# The handler
# ---------------------------------------------------------------------------


def invoke(event: dict, *, gate: Callable[[int], bool] | None = None,
           requeue: Callable[[int, BaseException], bool] | None = None) -> dict:
    """Run ONE task from a single JSON event; return the billing record.

    `gate`/`requeue` are the out-of-band control plane a platform would
    provide (a claim table the function consults): `gate(task) -> bool`
    is the speculation loser-abort predicate polled per fetched map
    chunk / merge window and immediately before the multipart commit;
    `requeue(task, exc) -> handled` reports a vanished reduce input.
    Everything else — store, plan, task — comes from the event alone.
    """
    from repro_torch.shuffle import runtime as rt

    phase = event["phase"]
    task = int(event["task"])
    bucket = event["bucket"]
    plan = _plan_from(event)
    limit = int(event.get("memory_limit_bytes")
                or plan.reduce_memory_budget_bytes or 0)
    _require(limit > 0, "memory_limit_bytes", event.get("memory_limit_bytes"),
             "a function invocation needs a memory bound (set it in the "
             "event or via plan.reduce_memory_budget_bytes)")
    # Fresh per-invocation metrics over the endpoint's store: the
    # invocation's own retry-inflated request counts are its bill.
    store = MetricsMiddleware(_resolve_store(event["store"]))
    control = rt.JobControl()
    timeline = rt.PhaseTimeline(origin=time.perf_counter())
    committed: list[int] = []
    requeued: list[int] = []

    popped = [task]
    def pop_once():
        return popped.pop() if popped else None

    t0 = time.perf_counter()
    if phase == "map":
        map_op = _map_op_for(event)
        # Billed LIST per invocation: task planning state is rebuilt
        # from the store, never assumed warm.
        map_op.plan_tasks(store, bucket)
        _require(task < len(map_op.waves), "task", task,
                 f"map phase has {len(map_op.waves)} tasks")
        # The map working set is one wave's records — the number the
        # function's memory size must cover. Enforced up front: the
        # wave either fits the sandbox or the invocation must not start.
        peak_bytes = int(plan.records_per_wave) * int(plan.record_bytes)
        if event.get("memory_limit_bytes") and peak_bytes > limit:
            raise ValueError(
                f"memory_limit_bytes={limit}: one map wave is {peak_bytes} "
                "bytes (records_per_wave * record_bytes) — shrink the wave "
                "or raise the function's memory size")
        with _DEVICE_LOCK:
            rt.run_map_tasks(
                store, bucket, map_op, pop_once, plan=plan,
                timeline=timeline, control=control,
                tag_prefix=f"{event['worker']}/inv-{task}/",
                on_done=committed.append, commit_gate=gate)
    elif phase == "reduce":
        peak_bytes = _invoke_reduce(event, store, plan, limit, pop_once,
                                    timeline, control, committed, requeued,
                                    gate=gate, requeue=requeue)
    else:
        raise ValueError(f"phase={phase!r}: expected 'map' or 'reduce'")
    control.raise_first()
    if phase == "reduce" and peak_bytes > limit:
        raise ValueError(
            f"memory_limit_bytes={limit}: measured merge peak {peak_bytes} "
            "bytes exceeded the invocation's memory bound")
    return {
        "worker": event["worker"], "phase": phase, "task": task,
        "seconds": time.perf_counter() - t0,
        "peak_bytes": int(peak_bytes),
        "committed": bool(committed), "requeued": bool(requeued),
        "stats": dataclasses.asdict(store.stats_snapshot()),
    }


def _invoke_reduce(event, store, plan, limit, pop_once, timeline, control,
                   committed, requeued, *, gate, requeue):
    """One reduce partition, fully store-recovered: a FRESH map op's run
    offsets are reloaded from spill metadata (no shared offsets dict —
    the invocation may merge runs a long-dead executor spilled), the
    single reducer gets the WHOLE per-invocation memory budget, and
    peak merge bytes are measured against it."""
    import numpy as np

    from repro_torch.shuffle import runtime as rt
    from repro_torch.shuffle.sort import (DeviceMergeReduceOp, MergeReduceOp,
                                          SortMapOp)

    bucket = event["bucket"]
    bounds = event.get("boundaries")
    map_op = SortMapOp(plan, int(event["num_workers"]),
                       boundaries=None if bounds is None else bounds,
                       device=event["device"])
    num_tasks = map_op.plan_tasks(store, bucket)

    def refresh_offsets() -> None:
        for meta in store.list_objects(bucket, plan.spill_prefix):
            md = meta.metadata
            if {"wave", "worker", "reducer_offsets"} <= md.keys():
                map_op.spill_offsets[(int(md["wave"]), int(md["worker"]))] = (
                    np.asarray(md["reducer_offsets"], np.int64))

    refresh_offsets()
    device = getattr(plan, "reduce_merge_impl", "numpy") == "device"
    reduce_op = (DeviceMergeReduceOp if device else MergeReduceOp)(plan, map_op)

    class _StoreBackedSources:
        """Mirror of worker_main's proxy: a KeyError from the offsets
        dict means a spill this invocation hasn't seen — refresh from
        the store; truly gone means ObjectNotFound (requeue, not crash)."""

        def __getattr__(self, attr):
            return getattr(reduce_op, attr)

        def sources(self, r: int):
            try:
                return reduce_op.sources(r)
            except KeyError:
                refresh_offsets()
                try:
                    return reduce_op.sources(r)
                except KeyError as e:
                    raise ObjectNotFound(
                        f"spill run offsets missing for partition {r}: {e}")

    def on_requeue(r, exc) -> bool:
        handled = bool(requeue(r, exc)) if requeue is not None else False
        if handled:
            requeued.append(r)
        return handled

    governor = rt.AdaptiveBudgetGovernor(
        budget=limit, chunk_cap=plan.merge_chunk_bytes,
        record_bytes=plan.record_bytes, slots=1, partitions=1)
    peak = rt.PeakTracker()
    shared = rt.ReduceShared(
        plan=plan, bucket=bucket, reduce_op=_StoreBackedSources(),
        governor=governor, timeline=timeline, peak=peak, control=control)
    scheduler = rt.ReduceScheduler(
        store, shared, width=1, runs_hint=num_tasks,
        tag_prefix=f"{event['worker']}/inv-", fatal=(WorkerFailure,),
        requeue=(ObjectNotFound,), on_requeue=on_requeue,
        commit_gate=gate, gate_poll=True)
    if device:
        with _DEVICE_LOCK:
            scheduler.run(pop_once, on_done=committed.append)
    else:
        scheduler.run(pop_once, on_done=committed.append)
    return int(peak.peak)


# ---------------------------------------------------------------------------
# The Worker-protocol front: a loop of invocations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InvocationRecord:
    """One function invocation's billing record (cost_model inputs)."""

    worker: str
    phase: str
    task: int
    seconds: float  # billed handler duration (cold start excluded)
    cold_start_s: float  # injected init latency paid before the handler
    peak_bytes: int  # measured (reduce) / working-set (map) memory
    committed: bool  # the task's output durably committed
    requeued: bool  # the attempt aborted on vanished input
    stats: StoreStats  # this invocation's retry-inflated requests


class FunctionWorker(Worker):
    """A serverless executor behind the unchanged Worker protocol.

    Each popped task becomes exactly one `invoke()` with a fresh JSON
    event (round-tripped through json.dumps to enforce purity — nothing
    can leak into the handler except the event and the store). Fault
    injection mirrors executor.FaultyWorker: `die_after_invocations`
    kills the worker at the pop BEFORE that invocation
    (pre-commit-deterministic), `fail_after_requests` trips a kill
    switch mid-invocation so in-flight multipart sessions are left
    dangling for the driver's durable-commit recovery to clean up.
    `last_beat()` stays None: invocations fail synchronously, there is
    no warm process to go silent.
    """

    def __init__(self, name: str, *, store, bucket: str, plan,
                 num_workers: int = 8, device="cuda", boundaries=None,
                 cold_start_s: float = 0.0,
                 memory_limit_bytes: int | None = None,
                 die_after_invocations: int | None = None,
                 fail_after_requests: int | None = None):
        _require(cold_start_s >= 0.0, "cold_start_s", cold_start_s,
                 "injected init latency must be >= 0 seconds")
        _require(memory_limit_bytes is None or memory_limit_bytes > 0,
                 "memory_limit_bytes", memory_limit_bytes,
                 "the invocation memory bound must be positive")
        self.name = name
        self._kill = KillSwitchMiddleware(
            store,
            exc_factory=lambda: WorkerFailure(
                f"{self.name}: store unreachable (invocation killed)"),
            fail_after_requests=fail_after_requests)
        # The driver-facing view: per-worker attribution, severed by
        # fence(). Invocations resolve THIS view via the endpoint token,
        # so a fenced worker's in-flight invocation dies at its next
        # store request — a mid-invocation kill, not a polite drain.
        self.store = MetricsMiddleware(self._kill)
        self._token = register_endpoint(self.store)
        self.bucket = bucket
        self.plan = plan
        self.num_workers = int(num_workers)
        self.device = str(device)
        self.boundaries = (None if boundaries is None
                           else [int(b) for b in np_asarray_1d(boundaries)])
        self.cold_start_s = float(cold_start_s)
        self.memory_limit_bytes = memory_limit_bytes
        self.invocations: list[InvocationRecord] = []
        self._lock = threading.Lock()
        self._die_after = die_after_invocations
        self._invoked = 0
        self._warm = False

    # -- event construction ---------------------------------------------

    def _event(self, phase: str, task: int) -> dict:
        event = {
            "version": 1,
            "worker": self.name,
            "phase": phase,
            "task": int(task),
            "bucket": self.bucket,
            "plan": dataclasses.asdict(self.plan),
            "num_workers": self.num_workers,
            "device": self.device,
            "boundaries": self.boundaries,
            "store": {"kind": "endpoint", "token": self._token},
            "memory_limit_bytes": self.memory_limit_bytes,
        }
        # The purity fence: the handler sees decoded JSON, nothing else.
        return json.loads(json.dumps(event))

    # -- the invocation loop ----------------------------------------------

    def _phase_loop(self, phase: str, ctx, pop_next, on_done) -> None:
        name = self.name
        if phase == "map":
            gate = (None if ctx.map_commit_gate is None
                    else (lambda g: ctx.map_commit_gate(name, g)))
            requeue_cb = None
        else:
            gate = (None if ctx.commit_gate is None
                    else (lambda r: ctx.commit_gate(name, r)))
            requeue_cb = (None if ctx.on_requeue is None
                          else (lambda r, e: ctx.on_requeue(name, r, e)))
        while True:
            with self._lock:
                if (self._die_after is not None
                        and self._invoked >= self._die_after):
                    # Injected platform failure at the pop, BEFORE any
                    # claim — pre-commit-deterministic, like
                    # FaultyWorker's task budget.
                    self._kill.trip()
                    raise WorkerFailure(
                        f"{name}: injected invocation budget exhausted")
            task = pop_next()
            if task is None:
                return
            cold = 0.0
            if not self._warm:
                cold = self.cold_start_s
                if cold:
                    time.sleep(cold)
                self._warm = True
            result = invoke(self._event(phase, task),
                            gate=gate, requeue=requeue_cb)
            with self._lock:
                self._invoked += 1
            self.invocations.append(InvocationRecord(
                worker=name, phase=phase, task=int(task),
                seconds=float(result["seconds"]), cold_start_s=cold,
                peak_bytes=int(result["peak_bytes"]),
                committed=bool(result["committed"]),
                requeued=bool(result["requeued"]),
                stats=StoreStats(**result["stats"])))
            if result["committed"]:
                on_done(task)

    def run_map_phase(self, ctx, pop_next, on_done):
        self._phase_loop("map", ctx, pop_next, on_done)

    def run_reduce_phase(self, ctx, pop_next, on_done):
        self._phase_loop("reduce", ctx, pop_next, on_done)

    def fence(self) -> None:
        self._kill.trip()


def np_asarray_1d(boundaries):
    import numpy as np
    return np.asarray(boundaries).reshape(-1)


# ---------------------------------------------------------------------------
# Fleet front end + accounting
# ---------------------------------------------------------------------------


class InvocationDriver:
    """Build a FunctionWorker fleet and run the sort as a serverless job.

    Composes the existing pieces unchanged: `sort_shuffle_job(...)
    .run(worker_list=fleet, fleet=FleetPlan(...))` — the elastic
    ClaimPool/driver provide claims, speculation, and death recovery;
    the functions provide nothing but invocations. `die_after_invocations`
    / `fail_after_requests` map worker index -> injected budget.
    """

    def __init__(self, store, bucket: str, *, plan, workers: int = 1,
                 num_workers: int = 8, device="cuda", boundaries=None,
                 fleet=None, tracer=None, cold_start_s: float = 0.0,
                 memory_limit_bytes: int | None = None,
                 die_after_invocations: Mapping[int, int] | None = None,
                 fail_after_requests: Mapping[int, int] | None = None):
        _require(workers >= 1, "workers", workers,
                 "a serverless fleet needs >= 1 concurrent function")
        self.store = store
        self.bucket = bucket
        self.plan = plan
        self.num_workers = int(num_workers)
        self.device = device
        self.boundaries = boundaries
        self.tracer = tracer
        self._fleet = fleet
        self.wall_seconds = 0.0
        self.report = None
        die = dict(die_after_invocations or {})
        failreq = dict(fail_after_requests or {})
        self.workers = [
            FunctionWorker(
                f"fn{i}", store=store, bucket=bucket, plan=plan,
                num_workers=num_workers, device=device, boundaries=boundaries,
                cold_start_s=cold_start_s,
                memory_limit_bytes=memory_limit_bytes,
                die_after_invocations=die.get(i),
                fail_after_requests=failreq.get(i))
            for i in range(int(workers))
        ]

    def run(self):
        from repro_torch.shuffle.elastic import FleetPlan
        from repro_torch.shuffle.sort import sort_shuffle_job

        job = sort_shuffle_job(
            self.store, self.bucket, num_workers=self.num_workers,
            plan=self.plan, tracer=self.tracer, boundaries=self.boundaries,
            device=self.device)
        t0 = time.perf_counter()
        # A function has no local spill tier to lose: its spills went to
        # the object store, which outlives every invocation. A dead
        # function therefore loses only its in-flight attempt — the
        # correlated-loss recovery (a VM taking its NVMe down with it)
        # stays off unless an explicit FleetPlan turns it on.
        self.report = job.run(
            worker_list=self.workers,
            fleet=self._fleet or FleetPlan(lose_spill_on_death=False))
        self.wall_seconds = time.perf_counter() - t0
        return self.report

    # -- accounting -------------------------------------------------------

    def invocations(self) -> list[InvocationRecord]:
        return [r for wk in self.workers for r in wk.invocations]

    def profiles(self):
        from repro_torch.core.cost_model import InvocationProfile
        return [InvocationProfile(seconds=r.seconds, peak_bytes=r.peak_bytes)
                for r in self.invocations()]

    def request_stats(self) -> StoreStats:
        """The serverless billing view: the sum of every invocation's
        own retry-inflated request counters."""
        total = StoreStats()
        for r in self.invocations():
            total = total + r.stats
        return total

    def tco(self, *, data_bytes: int, job_hours: float | None = None,
            reduce_hours: float | None = None, params=None):
        """Measured serverless TCO for this run (see core/cost_model)."""
        from repro_torch.core.cost_model import (ServerlessCostParams,
                                           measured_serverless_tco)
        if job_hours is None:
            job_hours = self.wall_seconds / 3600.0
        if reduce_hours is None:
            reduce_hours = sum(r.seconds for r in self.invocations()
                               if r.phase == "reduce") / 3600.0
        return measured_serverless_tco(
            self.profiles(), self.request_stats(),
            job_hours=job_hours, reduce_hours=reduce_hours,
            data_bytes=data_bytes,
            params=params or ServerlessCostParams())


__all__ = ["FunctionWorker", "InvocationDriver", "InvocationRecord",
           "event_from_reference", "invoke", "register_endpoint"]
