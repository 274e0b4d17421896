"""Operator protocols and plan/report contracts of the shuffle library.

Exoshuffle's claim is that a shuffle is three application-supplied
operators plus a partitioner, and everything else — staging, scheduling,
memory governance, fault recovery — is reusable library machinery. This
module is the contract between the two halves:

  MapOp        — turns one input split (a "map task") into partitioned
      spill runs in the store. The library owns prefetching splits ahead
      of compute and write-behind spilling; the op owns what a split is,
      how it is loaded, and how its records are routed/combined/encoded.

  CombineOp    — optional map-side pre-aggregation: applied to a
      partition-and-key-sorted record span before it is spilled, so
      repeated keys collapse at the mapper and the shuffle moves less
      data (the word-count combiner).

  ReduceOp     — streams one output partition's spill-run slices into
      output parts. The library owns the streaming cursors, the chunk
      budget, multipart upload fan-out, and durability confirmation; the
      op owns which (run, lo, hi) slices feed partition r and how
      buffered sorted fragments become output bytes (PartitionReducer).

  Partitioner  — the pluggable routing function (shuffle/partition.py):
      an ordered set of internal boundaries over a routed uint32 domain.
      The contract (tested property-style in tests/test_shuffle.py) is
      exhaustive, non-overlapping coverage: every routed key falls in
      exactly one of num_partitions ranges.

All plan validation on this surface raises ValueError with the offending
knob name and value (`require`) — never a bare assert, so the contract
survives `python -O`.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io.backends import StoreBackend, StoreStats

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.io.staging import AsyncWriter
    from repro_torch.shuffle.runtime import PhaseTimeline, Span


def require(condition: bool, knob: str, value, why: str) -> None:
    """Unified plan/operator validation: ValueError naming the offending
    knob and its value, consistently across ExternalSortPlan, ClusterPlan,
    and the shuffle plans. Never an assert — must survive python -O."""
    if not condition:
        raise ValueError(f"{knob}={value!r}: {why}")


def validate_dataflow_plan(plan) -> None:
    """Validate the generic dataflow knobs any shuffle plan must carry.

    Structural, not nominal: ShufflePlan and ExternalSortPlan both
    satisfy it. Workload plans add their own checks on top (e.g.
    WaveSorter's wave/mesh divisibility) — this is the shared floor the
    session enforces before any input byte is fetched (and billed).
    """
    require(plan.payload_words >= 0, "payload_words", plan.payload_words,
            "must be >= 0")
    rb = rec.record_bytes(plan.payload_words)
    require(plan.store_chunk_bytes >= 1, "store_chunk_bytes",
            plan.store_chunk_bytes, "must be >= 1 byte per map-download GET")
    require(plan.merge_chunk_bytes >= rb, "merge_chunk_bytes",
            plan.merge_chunk_bytes,
            f"must hold at least one {rb}-byte record, else the "
            "reduce-memory bound cannot be met")
    require(plan.output_part_records >= 1, "output_part_records",
            plan.output_part_records, "must be >= 1 record per output part")
    require(plan.prefetch_depth >= 1, "prefetch_depth", plan.prefetch_depth,
            "must keep >= 1 load in flight")
    require(plan.max_inflight_writes >= 1, "max_inflight_writes",
            plan.max_inflight_writes, "must allow >= 1 pending write")
    require(plan.io_retries >= 0, "io_retries", plan.io_retries,
            "must be >= 0")
    require(plan.parallel_reducers >= 1, "parallel_reducers",
            plan.parallel_reducers, "must run >= 1 streaming merge")
    require(plan.part_upload_fanout >= 1, "part_upload_fanout",
            plan.part_upload_fanout, "must allow >= 1 in-flight part upload")
    require(plan.reduce_memory_budget_bytes >= 0,
            "reduce_memory_budget_bytes", plan.reduce_memory_budget_bytes,
            "must be >= 0 (0 = uncapped)")
    for knob in ("input_prefix", "spill_prefix", "output_prefix"):
        require(bool(getattr(plan, knob)), knob, getattr(plan, knob),
                "must be a non-empty key prefix")
    # The three prefixes must be mutually non-overlapping (neither may be
    # a prefix of another): session preflight DELETES everything under
    # spill_prefix and output_prefix, so an overlap with input_prefix
    # would destroy the input before the map phase ever runs.
    names = ("input_prefix", "spill_prefix", "output_prefix")
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            va, vb = getattr(plan, a), getattr(plan, b)
            require(not va.startswith(vb) and not vb.startswith(va),
                    b, vb,
                    f"overlaps {a}={va!r} — prefixes must be disjoint "
                    "(the session clears spill/output prefixes between "
                    "runs)")


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """The generic dataflow schedule: store layout + streaming knobs.

    This is ExternalSortPlan minus everything sort-specific (mesh rounds,
    wave tiling, capacity factors): what any shuffle workload needs to
    say about prefixes, chunk granularities, concurrency, and the global
    reduce memory budget. See core/external_sort.ExternalSortPlan for
    the knob-by-knob invariants — they are identical here because the
    same runtime enforces them.
    """

    input_prefix: str = "input/"
    spill_prefix: str = "spill/"
    output_prefix: str = "output/"
    payload_words: int = 1  # u32 payload words per record
    store_chunk_bytes: int = 256 << 10  # map download GET granularity
    merge_chunk_bytes: int = 64 << 10  # reduce per-run fetch cap
    output_part_records: int = 1 << 13  # multipart-upload part size
    prefetch_depth: int = 2  # map split double buffering
    max_inflight_writes: int = 2  # spill / part-upload backpressure
    io_retries: int = 2  # staging-level re-reads of a failed split load
    parallel_reducers: int = 4  # concurrent streaming merges per scheduler
    reduce_memory_budget_bytes: int = 0  # global merge budget; 0 = uncapped
    part_upload_fanout: int = 2  # out-of-order part uploads per partition

    @property
    def record_bytes(self) -> int:
        return rec.record_bytes(self.payload_words)

    def validate(self) -> None:
        validate_dataflow_plan(self)


class Partitioner(abc.ABC):
    """Pluggable partition routing over a uint32 key domain.

    A partitioner is an ordered set of `num_partitions - 1` internal
    boundaries over a *routed* domain (identity for range partitioning,
    a hash for hash partitioning): key k belongs to partition
    `searchsorted(boundaries, route(k), side="right")`. The ranges are
    exhaustive and non-overlapping by construction — the property the
    partitioner test suite checks on every implementation.
    """

    num_partitions: int

    @abc.abstractmethod
    def boundaries(self) -> np.ndarray:
        """(num_partitions - 1,) ascending uint32 internal boundaries in
        the routed domain. A routed value v belongs to partition j iff
        boundaries[j-1] <= v < boundaries[j] (with the implicit outer
        bounds 0 and 2^32)."""

    def route(self, keys: np.ndarray) -> np.ndarray:
        """Map raw keys into the routed domain (identity by default)."""
        return np.asarray(keys, dtype=np.uint32)

    def partition_of(self, keys: np.ndarray) -> np.ndarray:
        """(n,) int64 destination partition per key."""
        routed = self.route(keys)
        return np.searchsorted(
            self.boundaries(), routed, side="right").astype(np.int64)


class MapOp(abc.ABC):
    """Turn one input split into partitioned spill runs.

    One instance is stateful for one job: `plan_tasks` fixes the split
    list (and the `total_records` / `working_set_records` accounting the
    report carries), `load` fetches one split (called on the staging
    pipeline's prefetch threads, possibly `io_retries` times), and
    `process` routes/sorts/combines/spills it through the library's
    write-behind `spiller`. Spill determinism is the load-bearing
    contract: the run bytes `process(task)` writes must depend only on
    (task id, plan, input) — never on which worker executes the task or
    how many times (cluster re-execution replays it verbatim).
    """

    total_records: int = 0  # set by plan_tasks
    working_set_records: int = 0  # largest split (report.oversubscription)
    num_mesh_workers: int = 1  # device-mesh width (1 for host-only ops)
    spill_objects_per_task: int = 1  # report accounting

    @abc.abstractmethod
    def plan_tasks(self, store: StoreBackend, bucket: str) -> int:
        """Enumerate input splits; returns the map-task count. Raises
        ValueError when there is no input under plan.input_prefix."""

    @abc.abstractmethod
    def load(self, store: StoreBackend, bucket: str, task: int):
        """Fetch split `task` (runs on a prefetch thread)."""

    @abc.abstractmethod
    def process(self, store: StoreBackend, bucket: str, task: int, data, *,
                spiller: "AsyncWriter", timeline: "PhaseTimeline",
                tag: str) -> None:
        """Partition + spill split `task` (loaded as `data`), submitting
        run puts through `spiller` and recording map.* spans."""

    def spill_keys(self, task: int) -> list[str]:
        """Lineage: every spill-run key `process(task)` writes. The
        elastic driver (shuffle/elastic.py) uses this to model correlated
        spill-tier loss — deleting a dead worker's runs and re-executing
        exactly the map tasks that produced them. Ops that don't support
        elastic spill loss may keep the default."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose spill lineage "
            "(required for FleetPlan.lose_spill_on_death)")

    # -- optional staged interface (pipelined map executor) --------------
    #
    # An op may additionally split `process` at the device boundary by
    # defining BOTH:
    #
    #   device_step(task, data, *, timeline, tag) -> staged
    #       The device-bound portion (sort/compute). Runs on a dedicated
    #       single-thread stage; must not touch the store. Records
    #       map.device_sort (and map.compute, for phase-total
    #       compatibility) spans.
    #
    #   encode_step(store, bucket, task, staged, *, spiller, timeline,
    #               tag) -> None
    #       The host-bound encode + spill portion. Runs on a second
    #       single-thread stage; receives `staged` from device_step and
    #       records map.encode / map.spill_wait spans.
    #
    # When the plan sets `map_pipeline` (see ExternalSortPlan) and both
    # methods exist, runtime.run_map_tasks software-pipelines the waves:
    # wave N's host decode (`load`) overlaps wave N-1's device_step and
    # wave N-2's encode_step. The two stages are each single-threaded
    # and consumed in task order, so spill bytes — and therefore the
    # whole shuffle output — are unchanged from the monolithic path.
    # Ops that only define `process` always run monolithically.


class CombineOp(abc.ABC):
    """Map-side pre-aggregation over a partition-and-key-sorted span.

    `combine` receives records already sorted so equal keys are
    contiguous (and never straddle a partition boundary, since equal
    keys route identically); it returns the collapsed span in the same
    order. The shuffle then spills and moves only the combined bytes.
    """

    @abc.abstractmethod
    def combine(self, keys: np.ndarray, ids: np.ndarray,
                payload: np.ndarray | None):
        """(keys, ids, payload) -> collapsed (keys, ids, payload)."""


class PartitionReducer(abc.ABC):
    """Per-partition streaming consumer: sorted fragments in, output
    bytes out. Created by ReduceOp.open(r); driven by the scheduler's
    emit cycles, which guarantee fragments arrive in ascending
    (key << 32 | id) order across calls and that `final=True` marks the
    cycle after which no more records exist."""

    #: True when part 0 is reserved for bytes only known at the end
    #: (e.g. a record-count header after aggregation): body parts are
    #: then indexed from 1 and `finalize` must return the part-0 bytes —
    #: the out-of-order multipart contract makes the upload order legal.
    deferred_part0: bool = False

    # -- optional execution-context hook ---------------------------------
    #
    # A reducer may define
    #
    #   bind_exec(*, timeline, tag) -> None
    #
    # and the scheduler calls it once, right after ReduceOp.open(),
    # before `begin`. It hands the sink the run's PhaseTimeline and this
    # partition's worker tag so sinks that do work off the scheduler
    # thread (e.g. the device merge's staged encode) can attribute their
    # spans. Purely observational: sinks without the hook behave
    # identically.

    @abc.abstractmethod
    def begin(self) -> bytes:
        """Bytes the part stream starts with (b"" when deferred)."""

    @abc.abstractmethod
    def consume(self, frags, *, final: bool) -> bytes:
        """Fold one emit cycle's per-run fragments (each a (keys, ids,
        payload, k64) tuple of sorted arrays) into output body bytes."""

    def finalize(self) -> tuple[bytes, bytes | None]:
        """(tail body bytes, deferred part-0 bytes or None). Called once
        after the last consume; the part-0 element must be non-None iff
        `deferred_part0`."""
        return b"", None


class ReduceOp(abc.ABC):
    """Stream one output partition's spill runs into output parts.

    The scheduler owns cursors, budget grants, uploads, and durability;
    the op owns the data: which byte slices of which run objects feed
    partition r (`sources`), where the output goes (`output_key`), and
    how sorted fragments become bytes (`open` -> PartitionReducer).

    Optional hooks (duck-typed, for ops that bypass the k-way merge —
    shuffle/recursive's redirected partitions):

      sequential_partition(r) -> bool — True makes the scheduler drain
          partition r's run cursors ONE AT A TIME (source order, runs=1
          budget grant) instead of merging them; the sink must accept
          unmerged fragments (a concatenator, not a merger). This is
          what removes the reduce fan-in ceiling for partitions headed
          into another shuffle round.
      feasibility_runs(num_tasks) -> int — the worst-case concurrent
          run fan-in for the session's budget preflight
          (runtime.reduce_chunking); defaults to num_tasks when absent.
    """

    payload_words: int = 0  # decode width of the spilled run records

    @abc.abstractmethod
    def sources(self, r: int) -> tuple[list[tuple[str, int, int]], int]:
        """([(run key, lo record, hi record)], total records) feeding
        output partition r — empty list for an empty partition."""

    @abc.abstractmethod
    def output_key(self, r: int) -> str:
        """Store key of partition r's output object."""

    def output_metadata(self, r: int, n_total: int) -> dict:
        return {"records": n_total, "partition": r}

    @abc.abstractmethod
    def open(self, r: int, n_total: int) -> PartitionReducer:
        """Create the streaming consumer for partition r."""


@dataclasses.dataclass
class ShuffleReport:
    """What happened: sizes, timings, and *measured* store traffic.

    Field names keep their CloudSort heritage (this class *is*
    core/external_sort.ExternalSortReport — the sort was the first
    instantiation): `num_waves` counts map tasks, `num_reducers` output
    partitions, `runs_per_reducer` the k of the streaming k-way merge.
    The generic aliases below read better for non-sort workloads.
    """

    total_records: int
    num_waves: int
    num_workers: int
    num_reducers: int
    spill_objects: int
    output_objects: int
    map_seconds: float
    reduce_seconds: float
    working_set_records: int
    stats: StoreStats  # delta over the job (map + reduce), all tiers
    runs_per_reducer: int = 0  # k of the streaming k-way merge
    merge_chunk_bytes: int = 0  # the plan's per-run fetch cap
    reduce_chunk_bytes: int = 0  # initial per-run chunk (budget-governed)
    reduce_chunk_bytes_max: int = 0  # largest chunk the governor granted
    reduce_peak_merge_bytes: int = 0  # measured max across ALL active merges
    parallel_reducers: int = 1  # concurrent merges the scheduler(s) ran
    reduce_memory_budget_bytes: int = 0  # the global governor (0 = none)
    tier_stats: dict[str, StoreStats] | None = None  # per-tier deltas
    spans: list["Span"] = dataclasses.field(default_factory=list)
    spans_dropped: int = 0  # spans beyond the recorder cap (totals stay exact)
    phase_seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)  # MetricsRegistry.snapshot()

    # -- generic aliases over the legacy sort-flavoured names ------------

    @property
    def num_map_tasks(self) -> int:
        return self.num_waves

    @property
    def num_partitions(self) -> int:
        return self.num_reducers

    @property
    def oversubscription(self) -> float:
        """Dataset size / per-split working set (>1 = out-of-core)."""
        return self.total_records / self.working_set_records

    @property
    def reduce_memory_bound_bytes(self) -> int:
        """The scheduler's memory guarantee: the global budget when one is
        set, else parallel_reducers x runs x effective chunk (+ one record
        of rounding per run) — reduce_peak_merge_bytes never exceeds it."""
        if self.reduce_memory_budget_bytes:
            return self.reduce_memory_budget_bytes
        chunk = self.reduce_chunk_bytes or self.merge_chunk_bytes
        return self.parallel_reducers * self.runs_per_reducer * chunk

    @property
    def job_hours(self) -> float:
        return (self.map_seconds + self.reduce_seconds) / 3600.0

    @property
    def reduce_hours(self) -> float:
        return self.reduce_seconds / 3600.0


@dataclasses.dataclass
class ClusterShuffleReport:
    """A cluster run's report: the single-host report plus the cluster
    story (who died, what was re-executed, who did what)."""

    report: ShuffleReport
    num_cluster_workers: int
    failed_workers: list[str]
    reexecuted_map_tasks: int
    reexecuted_reduce_tasks: int
    map_tasks: int
    reduce_tasks: int
    per_worker_stats: dict[str, StoreStats]
    per_worker_tasks: dict[str, int]
    # Elastic-fleet extras (shuffle/elastic.py); zero under the static
    # PhaseDriver so existing constructor call sites stay valid.
    speculated_tasks: int = 0  # duplicate attempts launched
    speculation_wins: int = 0  # duplicates that committed first
    heartbeat_misses: int = 0  # workers declared dead by silence
    spill_lost_map_tasks: int = 0  # map tasks re-run for lost spill runs
    requeued_reduce_tasks: int = 0  # reduce attempts parked on lost input
    workers_admitted: int = 0  # joined mid-job
    workers_retired: int = 0  # gracefully drained mid-job
    recovery_rounds: int = 0  # map-recovery passes after spill loss

    @property
    def sort(self) -> ShuffleReport:
        """Legacy alias: core/cluster.ClusterSortReport named the inner
        report `sort` back when sorting was the only workload."""
        return self.report

    @property
    def reexecuted_tasks(self) -> int:
        return self.reexecuted_map_tasks + self.reexecuted_reduce_tasks

    @property
    def spans_dropped(self) -> int:
        """Spans beyond the recorder cap (see runtime.PhaseTimeline
        `max_spans`); phase totals stay exact regardless."""
        return self.report.spans_dropped

    @property
    def metrics(self) -> dict:
        """The run's MetricsRegistry snapshot (see obs/metrics.py)."""
        return self.report.metrics


__all__ = [
    "ClusterShuffleReport",
    "CombineOp",
    "MapOp",
    "Partitioner",
    "PartitionReducer",
    "ReduceOp",
    "ShufflePlan",
    "ShuffleReport",
    "require",
    "validate_dataflow_plan",
]
