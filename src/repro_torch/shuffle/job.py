"""ShuffleJob / ShuffleSession: the library front end.

A ShuffleJob is a workload description — store + bucket + plan + the
three operators and a partitioner. One `job.run(workers=N)` call owns
everything the drivers used to hand-roll per workload:

  * plan validation (api.validate_dataflow_plan + the plan's own
    `validate`) and operator preflight, before any input byte is billed;
  * wave/split enumeration via MapOp.plan_tasks, budget feasibility
    (runtime.reduce_chunking) and the AdaptiveBudgetGovernor, sized to
    the cluster-wide merge concurrency;
  * stale spill/output prefix cleanup and baseline store counters, so
    the report's measured traffic is this run's alone;
  * the span timeline and job-wide cancellation;
  * execution: inline single-host (workers=0) or the multi-worker phase
    driver with durable-confirmation failure recovery (workers>=1, or an
    explicit Worker fleet for failure injection);
  * on a rank mesh (launch/mesh.RankMesh, a job built with `mesh=`):
    the inline driver on every rank, over all map tasks and the rank's
    share of the partitions, with rank 0 clearing the prefixes, barriers
    around the map, and the report gathered from every rank.

The sort and group-by instantiations (shuffle/sort.py,
shuffle/groupby.py) differ only in the operators they pass here — which
is the paper's point.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io.backends import StoreBackend, StoreStats
from repro_torch.obs.context import use_context
from repro_torch.obs.events import Tracer

from repro_torch.shuffle import executor as ex
from repro_torch.shuffle import runtime as rt
from repro_torch.shuffle.api import (ClusterShuffleReport, MapOp, Partitioner,
                               ReduceOp, ShuffleReport, require,
                               validate_dataflow_plan)
from repro_torch.shuffle.partition import quantile_boundaries


@dataclasses.dataclass
class KeySample:
    """Result of the sampling pre-pass (`sample_boundaries`): the
    splitter quantiles plus enough of the sampled distribution to
    predict per-partition sizes (the recursive driver's oversize
    criterion)."""

    boundaries: np.ndarray  # (parts-1,) uint32 routed-domain quantiles
    sample: np.ndarray  # sorted routed sample values (uint32)
    records_total: int  # records under the sampled prefix
    records_sampled: int
    get_requests: int  # ranged GETs the pre-pass issued (billed)
    seconds: float

    def partition_records(self) -> np.ndarray:
        """Estimated records per partition under `boundaries`: the
        sample's per-partition counts scaled to the full input (ceil —
        an overestimate errs toward re-shuffling, never toward an
        oversized merge)."""
        dest = np.searchsorted(self.boundaries, self.sample, side="right")
        counts = np.bincount(dest, minlength=self.boundaries.size + 1)
        scale = self.records_total / max(self.sample.size, 1)
        return np.ceil(counts * scale).astype(np.int64)


def sample_boundaries(store: StoreBackend, bucket: str, *, input_prefix: str,
                      payload_words: int, sample_fraction: float, parts: int,
                      tracer: Tracer | None = None,
                      route: Callable[[np.ndarray, np.ndarray], np.ndarray]
                      | None = None,
                      block_records: int = 256) -> KeySample:
    """The sampling pre-pass: Daytona-style splitter estimation over the
    real store, billed and traced like any other phase.

    Reads ~`sample_fraction` of every input object's records through
    evenly spaced ranged GETs (contiguous blocks of up to
    `block_records`, positions pure arithmetic — no RNG, so the
    resulting boundaries are deterministic for a given input + knobs)
    and returns the `parts`-way quantile splitters of the sampled keys.
    Runs under TraceContext phase="sample": a tracing store stack
    attributes the GETs/bytes to the sample phase, each fetch records a
    `sample.fetch` span, and a `phase.seconds{phase=sample}` gauge lands
    next to the map/reduce phase gauges.

    `route` optionally maps (keys, ids) -> routed uint32 values before
    the quantiles are taken — the recursive driver passes the
    next-key-bits routing of a sub-range so child boundaries live in the
    child's routed domain.
    """
    require(0.0 < sample_fraction <= 1.0, "sample_fraction", sample_fraction,
            "the sampling pre-pass needs a fraction in (0, 1]")
    require(parts >= 1, "parts", parts, "must split into >= 1 partition")
    require(block_records >= 1, "block_records", block_records,
            "must fetch >= 1 record per ranged GET")
    rb = rec.record_bytes(payload_words)
    tracer = tracer if tracer is not None else Tracer(job="shuffle")
    ctx = tracer.root.with_phase("sample").with_worker("host")
    t_start = time.perf_counter()
    gets = 0
    total = 0
    sampled_k: list[np.ndarray] = []
    sampled_i: list[np.ndarray] = []
    with use_context(ctx):
        inputs = store.list_objects(bucket, input_prefix)
        require(bool(inputs), "input_prefix", input_prefix,
                "no input objects to sample")
        for meta in inputs:
            n = (meta.size - rec.HEADER_BYTES) // rb
            total += n
            if n == 0:
                continue
            m = max(1, int(round(n * sample_fraction)))
            nblocks = -(-m // block_records)
            base, extra = divmod(m, nblocks)
            for b in range(nblocks):
                take = base + (1 if b < extra else 0)
                start_rec = min((b * n) // nblocks, n - take)
                off, length = rec.body_range(start_rec, take, payload_words)
                t0 = time.perf_counter()
                body = store.get_range(bucket, meta.key, off, length)
                gets += 1
                k, i, _ = rec.decode_body(body, payload_words)
                tracer.event("sample.fetch", t0, ctx=ctx, key=meta.key,
                             records=take, nbytes=length)
                sampled_k.append(k)
                sampled_i.append(i)
    keys = (np.concatenate(sampled_k) if sampled_k
            else np.empty((0,), np.uint32))
    ids = (np.concatenate(sampled_i) if sampled_i
           else np.empty((0,), np.uint32))
    require(keys.size >= 1, "input_prefix", input_prefix,
            "sampled zero records — every input object is empty")
    routed = keys if route is None else route(keys, ids)
    routed = np.sort(np.asarray(routed, np.uint32).reshape(-1))
    bounds = quantile_boundaries(routed, parts)
    seconds = time.perf_counter() - t_start
    tracer.event("sample.boundaries", t_start, ctx=ctx, parts=parts,
                 records_sampled=int(keys.size), records_total=int(total),
                 get_requests=gets)
    tracer.registry.gauge("phase.seconds", seconds, phase="sample")
    return KeySample(boundaries=bounds, sample=routed,
                     records_total=int(total),
                     records_sampled=int(keys.size), get_requests=gets,
                     seconds=seconds)


class ShuffleSession:
    """One prepared run of a ShuffleJob: validated plan, enumerated map
    tasks, feasibility-checked budget governor, cleared prefixes, and
    baseline store counters. Create via ShuffleJob.prepare()/run() —
    a session is single-use (the governor and operator state are one
    run's)."""

    def __init__(self, job: "ShuffleJob", *, schedulers: int):
        store, bucket, plan = job.store, job.bucket, job.plan
        self.job = job
        # Validation first: fail before any input byte is fetched/billed.
        if hasattr(plan, "validate"):
            plan.validate()
        else:
            validate_dataflow_plan(plan)
        self.num_tasks = job.map_op.plan_tasks(store, bucket)
        require(self.num_tasks >= 1, "input_prefix", plan.input_prefix,
                "MapOp.plan_tasks found no input splits")
        self.num_partitions = job.partitioner.num_partitions
        # On a rank mesh each rank reduces the partitions of its workers
        # (an equal contiguous share of R = W*R1) under its own governor:
        # the budget binds each rank's host.
        mesh = job.mesh
        self.partitions = (range(self.num_partitions) if mesh is None
                           else range(*mesh.share(self.num_partitions)))
        # Governor slots = the cluster-wide concurrent-merge ceiling:
        # every scheduler (one per worker) draws on one global budget.
        self.slots = min(max(int(schedulers), 1) * plan.parallel_reducers,
                         len(self.partitions))
        # One Tracer per run unless the job brought its own (examples
        # pass the same tracer to the store stack so request attempts
        # land on the same timeline as the spans).
        self.tracer = (job.tracer if job.tracer is not None
                       else Tracer(job="shuffle"))
        # Budget feasibility is pure plan validation (each partition
        # streams at most one run per map task). A ReduceOp that drains
        # every partition sequentially (shuffle/recursive's redirected
        # partitions pull one run at a time) reports its smaller
        # worst-case fan-in through the optional feasibility_runs hook.
        feas = getattr(job.reduce_op, "feasibility_runs", None)
        feas_runs = (max(1, int(feas(self.num_tasks))) if callable(feas)
                     else self.num_tasks)
        _, self.chunk_bytes = rt.reduce_chunking(plan, feas_runs, self.slots)
        self.governor = rt.AdaptiveBudgetGovernor(
            budget=plan.reduce_memory_budget_bytes,
            chunk_cap=plan.merge_chunk_bytes,
            record_bytes=plan.record_bytes,
            slots=self.slots,
            partitions=len(self.partitions),
            tracer=self.tracer,
        )
        # Overwrite semantics: clear stale spill/output objects from any
        # prior run so the reduce pass and downstream validation see only
        # this run. On a mesh only rank 0 clears, and the others wait for
        # it: a late rank must not delete an early rank's fresh spills.
        if mesh is None or mesh.rank == 0:
            for prefix in (plan.spill_prefix, plan.output_prefix):
                for meta in store.list_objects(bucket, prefix):
                    store.delete(bucket, meta.key)
        if mesh is not None:
            mesh.barrier()
        # Bare data planes (no MetricsMiddleware anywhere) still run;
        # their reports just carry zeroed counters.
        self.base_stats = (store.stats_snapshot()
                           if hasattr(store, "stats_snapshot")
                           else StoreStats())
        self.tier_base = (store.per_tier_stats()
                          if hasattr(store, "per_tier_stats") else None)
        # Run-scoped execution state. The timeline mirrors every span
        # into the tracer (absolute times; the tracer normalises to its
        # own origin), so the Chrome trace sees exactly what the report
        # sees.
        self.timeline = rt.PhaseTimeline(origin=time.perf_counter(),
                                         sink=self.tracer.timeline_sink())
        self.control = rt.JobControl()
        self.peak = rt.PeakTracker()
        self.shared = rt.ReduceShared(
            plan=plan, bucket=bucket, reduce_op=job.reduce_op,
            governor=self.governor, timeline=self.timeline, peak=self.peak,
            control=self.control,
        )

    # -- execution ---------------------------------------------------------

    def run_single_host(self) -> ShuffleReport:
        """The inline driver: one staged map loop, one reduce scheduler
        running `slots` streaming merges. On a rank mesh every rank runs
        every map task, in task order (each wave's device step is one
        collective program), then its share of the partitions; map and
        reduce are timed between barriers, and every rank returns the
        report merged from all of them (merge_rank_reports)."""
        job = self.job
        store, bucket, plan, mesh = job.store, job.bucket, job.plan, job.mesh
        t0 = time.perf_counter()
        pending = collections.deque(range(self.num_tasks))
        pop_lock = threading.Lock()

        def pop_task() -> int | None:
            with pop_lock:
                return pending.popleft() if pending else None

        with use_context(self.tracer.root):
            rt.run_map_tasks(store, bucket, job.map_op, pop_task, plan=plan,
                             timeline=self.timeline, control=self.control)
        if mesh is not None:
            mesh.barrier()
        map_seconds = time.perf_counter() - t0

        parts = collections.deque(self.partitions)

        def pop_partition() -> int | None:
            with pop_lock:
                return parts.popleft() if parts else None

        t0 = time.perf_counter()
        with use_context(self.tracer.root):
            rt.ReduceScheduler(store, self.shared, width=self.slots,
                               runs_hint=self.num_tasks).run(pop_partition)
        self.control.raise_first()
        reduce_seconds = time.perf_counter() - t0
        report = self.build_report(map_seconds=map_seconds,
                                   reduce_seconds=reduce_seconds)
        if mesh is None:
            return report
        return merge_rank_reports(mesh.all_gather_object(report))

    def run_cluster(self,
                    workers: Sequence[ex.Worker]) -> ClusterShuffleReport:
        """The multi-worker driver: two barriered phases of rounds over
        the surviving fleet, re-executing whatever a dead worker never
        durably confirmed (see shuffle/executor.PhaseDriver)."""
        job = self.job
        ctx = ex.WorkerContext(
            plan=job.plan, bucket=job.bucket, map_op=job.map_op,
            reduce_shared=self.shared, timeline=self.timeline,
            control=self.control, num_map_tasks=self.num_tasks,
        )
        driver = ex.PhaseDriver(workers, tracer=self.tracer)

        t_origin = time.perf_counter()
        reexec_map = driver.run_phase(
            "map", list(range(self.num_tasks)),
            lambda wk, pop, done: wk.run_map_phase(ctx, pop, done),
            self.control)
        map_seconds = time.perf_counter() - t_origin

        t_reduce = time.perf_counter()
        reexec_reduce = driver.run_phase(
            "reduce", list(range(self.num_partitions)),
            lambda wk, pop, done: wk.run_reduce_phase(ctx, pop, done),
            self.control)
        reduce_seconds = time.perf_counter() - t_reduce

        return ClusterShuffleReport(
            report=self.build_report(map_seconds=map_seconds,
                                     reduce_seconds=reduce_seconds),
            num_cluster_workers=len(driver.workers),
            failed_workers=list(driver.failed_workers),
            reexecuted_map_tasks=reexec_map,
            reexecuted_reduce_tasks=reexec_reduce,
            map_tasks=self.num_tasks,
            reduce_tasks=self.num_partitions,
            per_worker_stats=driver.per_worker_stats(),
            per_worker_tasks=dict(driver.per_worker_tasks),
        )

    def run_elastic(self, workers: Sequence[ex.Worker],
                    fleet) -> ClusterShuffleReport:
        """The elastic driver: membership + heartbeats, in-phase claim
        release, straggler speculation with loser-abort commits, and
        correlated spill-tier loss with lineage-tracked map re-execution
        (see shuffle/elastic.ElasticPhaseDriver). `fleet` is a
        shuffle/elastic.FleetPlan. Returns the driver too — callers that
        admit/retire workers mid-job grab it via `session.driver`."""
        from repro_torch.shuffle.elastic import ElasticPhaseDriver

        job = self.job
        ctx = ex.WorkerContext(
            plan=job.plan, bucket=job.bucket, map_op=job.map_op,
            reduce_shared=self.shared, timeline=self.timeline,
            control=self.control, num_map_tasks=self.num_tasks,
        )
        driver = self.driver = ElasticPhaseDriver(
            workers, fleet=fleet, store=job.store, bucket=job.bucket,
            tracer=self.tracer)
        driver.run_job(ctx, num_map_tasks=self.num_tasks,
                       num_partitions=self.num_partitions)
        self.control.raise_first()
        counters = driver.pool_counters()
        return ClusterShuffleReport(
            report=self.build_report(map_seconds=driver.map_seconds,
                                     reduce_seconds=driver.reduce_seconds),
            num_cluster_workers=len(driver.workers),
            failed_workers=list(driver.failed_workers),
            map_tasks=self.num_tasks,
            reduce_tasks=self.num_partitions,
            per_worker_stats=driver.per_worker_stats(),
            per_worker_tasks=dict(driver.per_worker_tasks),
            heartbeat_misses=driver.heartbeat_misses,
            spill_lost_map_tasks=driver.spill_lost_map_tasks,
            requeued_reduce_tasks=driver.requeued_reduce_tasks,
            workers_admitted=driver.workers_admitted,
            workers_retired=driver.workers_retired,
            recovery_rounds=driver.recovery_rounds,
            **counters,
        )

    # -- reporting ---------------------------------------------------------

    def build_report(self, *, map_seconds: float,
                     reduce_seconds: float) -> ShuffleReport:
        """Assemble the run report from the session + measured state —
        the one place the report contract is populated, for every
        workload and both execution modes."""
        job = self.job
        store, plan, map_op = job.store, job.plan, job.map_op
        tier_stats = None
        if self.tier_base is not None:
            tier_now = store.per_tier_stats()
            tier_stats = {name: tier_now[name] - self.tier_base[name]
                          for name in tier_now}
        reg = self.tracer.registry
        reg.gauge("phase.seconds", map_seconds, phase="map")
        reg.gauge("phase.seconds", reduce_seconds, phase="reduce")
        # Derive bytes/s gauges from the phase-labelled byte counters the
        # TracingMiddleware maintains (zero counters = no tracing store
        # wired in; skip rather than emit misleading zero rates).
        for phase, seconds, metric in (
                ("map", map_seconds, "store.bytes_read"),
                ("map", map_seconds, "store.bytes_written"),
                ("reduce", reduce_seconds, "store.bytes_read"),
                ("reduce", reduce_seconds, "store.bytes_written")):
            nbytes = reg.total(metric, phase=phase)
            if nbytes and seconds > 0:
                reg.gauge(metric + "_per_s", nbytes / seconds, phase=phase)
        return ShuffleReport(
            total_records=map_op.total_records,
            num_waves=self.num_tasks,
            num_workers=map_op.num_mesh_workers,
            num_reducers=self.num_partitions,
            spill_objects=self.num_tasks * map_op.spill_objects_per_task,
            output_objects=len(self.partitions),
            map_seconds=map_seconds,
            reduce_seconds=reduce_seconds,
            working_set_records=map_op.working_set_records,
            stats=(store.stats_snapshot() - self.base_stats
                   if hasattr(store, "stats_snapshot") else StoreStats()),
            runs_per_reducer=self.num_tasks,
            merge_chunk_bytes=plan.merge_chunk_bytes,
            reduce_chunk_bytes=self.chunk_bytes,
            reduce_chunk_bytes_max=self.governor.max_chunk_bytes,
            reduce_peak_merge_bytes=self.peak.peak,
            parallel_reducers=self.slots,
            reduce_memory_budget_bytes=plan.reduce_memory_budget_bytes,
            tier_stats=tier_stats,
            spans=self.timeline.spans(),
            spans_dropped=self.timeline.dropped,
            phase_seconds=self.timeline.totals(),
            metrics=reg.snapshot(),
        )


def merge_rank_reports(reports: Sequence[ShuffleReport]) -> ShuffleReport:
    """One report of a run on a rank mesh from each rank's: map and reduce
    seconds the slowest rank's, store counters, object counts and phase
    totals summed, the merge peak the largest rank's (each rank has its
    own budget), spans of every rank with the worker tagged "rank<r>/".
    The plan-wide fields (records, waves, W, R) are every rank's alike."""
    first = reports[0]

    def total(stats):
        return sum(stats, StoreStats())

    phase_seconds: dict[str, float] = collections.defaultdict(float)
    for rep in reports:
        for name, sec in rep.phase_seconds.items():
            phase_seconds[name] += sec
    return dataclasses.replace(
        first,
        spill_objects=sum(r.spill_objects for r in reports),
        output_objects=sum(r.output_objects for r in reports),
        map_seconds=max(r.map_seconds for r in reports),
        reduce_seconds=max(r.reduce_seconds for r in reports),
        stats=total(r.stats for r in reports),
        tier_stats=(None if first.tier_stats is None else {
            tier: total(r.tier_stats[tier] for r in reports)
            for tier in first.tier_stats}),
        reduce_peak_merge_bytes=max(r.reduce_peak_merge_bytes
                                    for r in reports),
        spans=[dataclasses.replace(sp, worker=f"rank{i}/{sp.worker}")
               for i, r in enumerate(reports) for sp in r.spans],
        spans_dropped=sum(r.spans_dropped for r in reports),
        phase_seconds=dict(phase_seconds))


class ShuffleJob:
    """A shuffle workload: operators + partitioner + plan over one store.

    The public entry point of the library. `run(workers=N)` executes the
    whole dataflow — N=0 inline on the calling host, N>=1 across N
    emulated workers with application-level failure recovery; pass
    `cluster=` (a shuffle/executor.ClusterPlan) to inject worker deaths,
    or `worker_list=` to bring a hand-built Worker fleet. A job with a
    `mesh` (launch/mesh.RankMesh) is run by every rank with `run()`.
    """

    def __init__(self, store: StoreBackend, bucket: str, *, plan,
                 map_op: MapOp, reduce_op: ReduceOp,
                 partitioner: Partitioner, tracer: Tracer | None = None,
                 mesh=None):
        self.store = store
        self.bucket = bucket
        self.plan = plan
        self.map_op = map_op
        self.reduce_op = reduce_op
        self.partitioner = partitioner
        self.tracer = tracer
        self.mesh = mesh

    def prepare(self, *, schedulers: int = 1) -> ShuffleSession:
        """Preflight one run (validation, task enumeration, governor,
        prefix cleanup) without executing it. `schedulers` is how many
        reduce schedulers will draw on the global budget (1 single-host;
        the worker count in cluster mode)."""
        return ShuffleSession(self, schedulers=schedulers)

    def run(self, workers: int = 0, *,
            cluster: ex.ClusterPlan | None = None,
            worker_list: Sequence[ex.Worker] | None = None,
            fleet=None):
        """Execute the job; returns a ShuffleReport (single-host) or a
        ClusterShuffleReport (cluster mode). Passing `fleet` (a
        shuffle/elastic.FleetPlan) with a `worker_list` selects the
        elastic driver — heartbeats, speculation, spill-loss recovery —
        instead of the round-barriered PhaseDriver."""
        if worker_list is not None:
            crew: Sequence[ex.Worker] | None = list(worker_list)
        elif cluster is not None:
            crew = ex.build_workers(self.store, cluster)
        elif workers >= 1:
            crew = ex.build_workers(self.store,
                                    ex.ClusterPlan(num_workers=workers))
        else:
            crew = None
        if crew is None:
            require(fleet is None, "fleet", fleet,
                    "the elastic driver needs a worker_list")
            return self.prepare(schedulers=1).run_single_host()
        require(self.mesh is None, "workers", workers,
                "a job on a rank mesh runs the inline driver on each rank: "
                "run() with no workers, cluster or worker_list")
        require(len(crew) >= 1, "worker_list", len(crew),
                "must supply >= 1 worker")
        session = self.prepare(schedulers=len(crew))
        if fleet is not None:
            return session.run_elastic(crew, fleet)
        return session.run_cluster(crew)


__all__ = ["KeySample", "ShuffleJob", "ShuffleSession", "merge_rank_reports",
           "sample_boundaries"]
