"""Recursive multi-round shuffle: the library composed with itself.

Port of src/repro/shuffle/recursive.py: round 1 sorts on `device` with
the W workers as a batch axis (shuffle/sort.SortMapOp), where the
reference sorts on a mesh; the sampled boundaries reach the partition
kernel as explicit boundaries (the power-of-two shift fast path is off
for them, core/keyspace.py). Child rounds sort on the host, as in the
reference, so their bytes never depend on the device.

The paper's single-pass sort is bounded by reduce fan-in: partition r
must stream one run per map task under reduce_memory_budget_bytes, so
dataset size is capped by budget x map tasks. serverless-sort's radix
planner (SNIPPETS.md snippet 1) shows the way out — shuffle by leading
key bits until every category fits one buffer. `recursive_sort` is that
idea expressed in this library's own terms, which is the point: every
round is a plain composed ShuffleJob.

Round structure:

  sample  — `shuffle/job.sample_boundaries` reads a deterministic,
      evenly spaced `plan.sample_fraction` of the input through ranged
      GETs (billed + traced as its own phase, "sample") and produces the
      Daytona-style quantile splitters that replace the equal Indy
      split in BOTH the device keyspace routing and the host
      RangePartitioner.

  round 1 — the normal device-path sort job (shuffle/sort.SortMapOp +
      MergeReduceOp), except partitions the sample PREDICTS will exceed
      the reduce budget are *redirected*: their reduce doesn't k-way
      merge at all — a _ConcatSink concatenates run slices (drained
      sequentially, one cursor at a time, budget grant of ONE run) into
      a staged object under `<output_prefix minus '/'>.rounds/`. The
      fan-in ceiling vanishes for exactly the partitions that would
      have hit it.

  observe — any non-redirected output the round *measures* oversized
      (the sampler missed it, or sampling was off) is restaged by a
      copy and recursed too, so the guarantee doesn't depend on sample
      quality.

  round d>1 — every staged partition becomes a child ShuffleJob over
      its own three disjoint prefixes. The child partitions by "the
      next key bits": the routed domain is the high 32 bits of
      (key<<32|id - lo64) >> shift over the parent partition's packed
      sub-range — for a parent range wider than one key these are the
      unconsumed key bits; for a single duplicated hot key the route
      degenerates to the record id, which splits a partition no key
      boundary can. Child map tasks host-sort (stable, by packed
      key<<32|id) the staged chunks; child outputs land at
      `<parent output key>/sub-NNNNN`, which list_objects orders
      exactly where the parent object would have been — so
      valsort.validate_from_store streams the final prefix unchanged.

Determinism: sample positions, predictions, redirects, observation,
concat order (source order), and child boundaries are all pure
arithmetic over the input — no RNG, no wall clock — so the final output
bytes and etags are identical at any worker count, parallelism, or
under worker kills/speculation (pinned by tests/test_shuffle.py and the
tests/chaos.py recursive-kill schedule). Staging lives under the
durable output tier, never under spill_prefix, so a dead worker's
correlated spill-tier loss cannot destroy a committed round input.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io.backends import StoreBackend
from repro_torch.obs.events import Tracer

from repro_torch.shuffle import runtime as _rt
from repro_torch.shuffle.api import (MapOp, PartitionReducer, Partitioner,
                               ReduceOp, require)
from repro_torch.shuffle.job import KeySample, ShuffleJob, sample_boundaries
from repro_torch.shuffle.partition import RangePartitioner

def recurse_prefix(plan) -> str:
    """Staging root for recursive rounds: a sibling of output_prefix
    (`output.rounds/` next to `output/`) — lexicographically disjoint
    from input/spill/output, so no session preflight or final listing
    ever sweeps staged round inputs."""
    return plan.output_prefix.rstrip("/") + ".rounds/"


@dataclasses.dataclass(frozen=True)
class KeyRoute:
    """Monotone map from one parent partition's packed (key<<32|id)
    sub-range [lo64, hi64) onto a uint32 routed domain — "the next key
    bits": (k64 - lo64) >> shift with the smallest shift that fits the
    span into 32 bits. Order-preserving in (key, id), so sub-partition
    concatenation is globally sorted; a single-key parent range
    degenerates to routing by id."""

    lo64: int
    hi64: int

    @property
    def shift(self) -> int:
        span = self.hi64 - self.lo64
        return max(0, (span - 1).bit_length() - 32) if span > 1 else 0

    @property
    def routed_span(self) -> int:
        """Number of distinct routed values (<= 2^32)."""
        return -(-(self.hi64 - self.lo64) // (1 << self.shift))

    def routed(self, keys: np.ndarray, ids: np.ndarray) -> np.ndarray:
        k64 = (np.asarray(keys, np.uint64) << np.uint64(32)) | np.asarray(
            ids, np.uint64)
        return ((k64 - np.uint64(self.lo64))
                >> np.uint64(self.shift)).astype(np.uint32)

    def equal_bounds(self, parts: int) -> np.ndarray:
        """(parts-1,) equal split of the routed span — the sampling-off
        fallback (pure radix: equal ranges of the next key bits)."""
        js = np.arange(1, parts, dtype=np.uint64)
        return ((js * np.uint64(self.routed_span))
                // np.uint64(parts)).astype(np.uint32)

    def sub_range64(self, routed_bounds: np.ndarray,
                    j: int) -> tuple[int, int]:
        """Packed sub-range [lo64, hi64) of child partition j under
        `routed_bounds` — the preimage of routed range j, clipped to the
        parent range."""
        parts = len(routed_bounds) + 1
        lo = (self.lo64 if j == 0
              else self.lo64 + (int(routed_bounds[j - 1]) << self.shift))
        hi = (self.hi64 if j == parts - 1
              else min(self.hi64,
                       self.lo64 + (int(routed_bounds[j]) << self.shift)))
        return lo, hi


class SubrangePartitioner(Partitioner):
    """Order-preserving partitioner for a recursive round: boundaries
    live in the parent sub-range's routed (next key bits) domain.

    `partition_of` routes raw uint32 keys with id=0 — ties on a
    duplicated key all land in the lowest candidate sub-partition, which
    keeps the monotone/exhaustive partitioner properties. The exact
    per-record routing (keys AND ids) is `partition_of64`, the one the
    map op's spill offsets use."""

    def __init__(self, num_partitions: int, route: KeyRoute,
                 boundaries: np.ndarray):
        require(num_partitions >= 1, "num_partitions", num_partitions,
                "must be >= 1")
        self.num_partitions = int(num_partitions)
        self.key_route = route
        bounds = np.asarray(boundaries, dtype=np.uint32).reshape(-1)
        require(bounds.shape[0] == self.num_partitions - 1,
                "boundaries", bounds.shape[0],
                f"must supply num_partitions-1 = "
                f"{self.num_partitions - 1} internal boundaries")
        require(bool(np.all(bounds[1:] >= bounds[:-1])),
                "boundaries", bounds.tolist(),
                "must be ascending (non-overlapping ranges)")
        self._bounds = bounds

    def boundaries(self) -> np.ndarray:
        return self._bounds

    def route(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint32)
        return self.key_route.routed(keys, np.zeros(keys.shape, np.uint32))

    def partition_of64(self, keys: np.ndarray,
                       ids: np.ndarray) -> np.ndarray:
        routed = self.key_route.routed(keys, ids)
        return np.searchsorted(self._bounds, routed,
                               side="right").astype(np.int64)


class _ConcatSink(PartitionReducer):
    """Pass-through sink for a partition headed into another round: no
    merge — fragments are re-encoded in arrival order. Used only with
    the scheduler's sequential drain (ReduceOp.sequential_partition), so
    arrival order is source order: deterministic bytes at any
    parallelism. The staged object is a valid records object whose body
    is NOT sorted; the child round re-sorts it from scratch."""

    deferred_part0 = False

    def __init__(self, n_total: int, payload_words: int):
        self._n = int(n_total)
        self._pw = int(payload_words)

    def begin(self) -> bytes:
        return rec.encode_header(self._n, self._pw)

    def consume(self, frags, *, final: bool) -> bytes:
        return b"".join(rec.encode_body(k, i, p)
                        for k, i, p, _k64 in frags if k.size)


class RedirectReduceOp(ReduceOp):
    """Wrap any ReduceOp so `redirect`ed partitions concat to staging
    keys (sequentially, one run cursor at a time) instead of merging to
    their output keys. Non-redirected partitions pass through to the
    wrapped op untouched — same sources, sink, and bytes."""

    def __init__(self, base: ReduceOp, redirect: dict[int, str],
                 num_partitions: int):
        self.base = base
        self.payload_words = base.payload_words
        self.redirect = dict(redirect)
        self.num_partitions = int(num_partitions)

    def sources(self, r: int):
        return self.base.sources(r)

    def output_key(self, r: int) -> str:
        key = self.redirect.get(r)
        return key if key is not None else self.base.output_key(r)

    def output_metadata(self, r: int, n_total: int) -> dict:
        return self.base.output_metadata(r, n_total)

    def open(self, r: int, n_total: int) -> PartitionReducer:
        if r in self.redirect:
            return _ConcatSink(n_total, self.payload_words)
        return self.base.open(r, n_total)

    # Scheduler hooks (see shuffle/api.ReduceOp): redirected partitions
    # drain one run at a time, so when EVERY partition is redirected the
    # budget preflight only needs one run's chunk per slot.
    def sequential_partition(self, r: int) -> bool:
        return r in self.redirect

    def feasibility_runs(self, num_tasks: int) -> int:
        return (1 if len(self.redirect) >= self.num_partitions
                else num_tasks)


class SubrangeSortMapOp(MapOp):
    """Host-side map op for a recursive round: ranged-GET chunks of the
    staged (unsorted) parent partition, stable-sort each by packed
    (key << 32 | id), spill one run per task with reducer offsets at the
    routed boundaries. No device sort — a child round is at most a few
    multiples of the reduce budget by construction, and its spill
    offsets are exactly as deterministic as the device path's."""

    spill_objects_per_task = 1

    def __init__(self, plan, partitioner: SubrangePartitioner):
        self.plan = plan
        self.partitioner = partitioner
        self.spill_offsets: dict[tuple[int, int], np.ndarray] = {}
        self.tasks: list[tuple[str, int, int]] = []

    def plan_tasks(self, store: StoreBackend, bucket: str) -> int:
        plan = self.plan
        rb = plan.record_bytes
        inputs = store.list_objects(bucket, plan.input_prefix)
        if not inputs:
            raise ValueError(
                f"input_prefix={plan.input_prefix!r}: no staged round input")
        self.tasks = []
        total = biggest = 0
        for m in inputs:
            n = (m.size - rec.HEADER_BYTES) // rb
            total += n
            for lo in range(0, n, plan.records_per_wave):
                hi = min(lo + plan.records_per_wave, n)
                self.tasks.append((m.key, lo, hi))
                biggest = max(biggest, hi - lo)
        self.total_records = total
        self.working_set_records = biggest
        return len(self.tasks)

    def load(self, store: StoreBackend, bucket: str, task: int):
        key, lo, hi = self.tasks[task]
        start, length = rec.body_range(lo, hi - lo, self.plan.payload_words)
        body = store.get_range(bucket, key, start, length)
        return rec.decode_body(body, self.plan.payload_words)

    def spill_keys(self, task: int) -> list[str]:
        return [f"{self.plan.spill_prefix}task-{task:04d}"]

    def process(self, store: StoreBackend, bucket: str, task: int, data, *,
                spiller, timeline, tag) -> None:
        keys, ids, payload = data
        t0 = time.perf_counter()
        k64 = (keys.astype(np.uint64) << np.uint64(32)) | ids.astype(
            np.uint64)
        order = np.argsort(k64, kind="stable")
        sk, si = keys[order], ids[order]
        sp = None if payload is None else payload[order]
        # routed is monotone in k64, so it is ascending over the sorted
        # run: offsets[j] = #{routed < bound_j}, the device kernel's
        # exact contract (kernels/range_partition).
        routed = self.partitioner.key_route.routed(sk, si)
        internal = np.searchsorted(routed, self.partitioner.boundaries(),
                                   side="left")
        offsets = np.concatenate(([0], internal, [sk.size])).astype(np.int64)
        self.spill_offsets[(task, 0)] = offsets
        encoded = rec.encode_records(sk, si, sp)
        timeline.add("map.compute", t0, worker=tag)
        t_spill = time.perf_counter()
        spiller.submit(_rt.timed_put, timeline, tag, store, bucket,
                       self.spill_keys(task)[0], encoded, {
                           "records": int(sk.size),
                           "task": task,
                           "reducer_offsets": [int(o) for o in offsets],
                       })
        timeline.add("map.spill_wait", t_spill, worker=tag)


class SubrangeMergeReduceOp(ReduceOp):
    """Reduce side of a recursive round: sub-partition r streams its
    slice of every task's run through the standard k-way merge sink into
    `<output_prefix>sub-NNNNN`."""

    def __init__(self, plan, map_op: SubrangeSortMapOp):
        self.plan = plan
        self.map_op = map_op
        self.payload_words = plan.payload_words

    def sources(self, r: int):
        slices, n_total = [], 0
        for t in range(len(self.map_op.tasks)):
            offs = self.map_op.spill_offsets[(t, 0)]
            lo, hi = int(offs[r]), int(offs[r + 1])
            if hi > lo:
                slices.append((self.map_op.spill_keys(t)[0], lo, hi))
                n_total += hi - lo
        return slices, n_total

    def output_key(self, r: int) -> str:
        return f"{self.plan.output_prefix}sub-{r:05d}"

    def output_metadata(self, r: int, n_total: int) -> dict:
        return {"records": n_total, "reducer": r}

    def open(self, r: int, n_total: int) -> PartitionReducer:
        from repro_torch.shuffle.sort import _SortMergeSink

        return _SortMergeSink(n_total, self.payload_words)


@dataclasses.dataclass
class RecursiveSortReport:
    """Aggregate of a recursive_sort run: the per-round reports plus the
    recursion decisions, for assertions and the skew benchmark."""

    rounds: list  # (depth, path, ShuffleReport | ClusterShuffleReport)
    sample: KeySample | None
    recursed: list[str]  # partition paths that got their own round
    restaged: list[str]  # subset recursed by OBSERVATION (sampler miss)
    output_objects: int

    @property
    def num_rounds(self) -> int:
        return max((d for d, _, _ in self.rounds), default=0)

    @property
    def report(self):
        """The round-1 report (top-level phase timings / store traffic)."""
        return self.rounds[0][2]


@dataclasses.dataclass(frozen=True)
class _Item:
    """One staged partition awaiting its own round."""

    path: str  # e.g. "part-00003" or "part-00003/sub-00001"
    in_prefix: str  # staging dir holding the partition's bytes
    lo64: int  # packed (key<<32|id) range covered, [lo64, hi64)
    hi64: int
    records: int
    depth: int


def _clear_prefix(store: StoreBackend, bucket: str, prefix: str) -> None:
    for meta in store.list_objects(bucket, prefix):
        store.delete(bucket, meta.key)


def _run_job(job: ShuffleJob, *, workers, cluster, worker_list, fleet):
    return job.run(workers, cluster=cluster, worker_list=worker_list,
                   fleet=fleet)


def recursive_sort(store: StoreBackend, bucket: str, *, num_workers: int,
                   plan, device="cuda", workers: int = 0, cluster=None,
                   worker_list: Sequence | None = None, fleet=None,
                   tracer: Tracer | None = None) -> RecursiveSortReport:
    """Skew-adaptive, recursively composed sort of plan.input_prefix into
    plan.output_prefix.

    With plan.sample_fraction > 0, a sampling pre-pass sets the
    partition boundaries (and predicts which partitions to redirect);
    with plan.max_rounds > 1, partitions whose merged size would exceed
    plan.reduce_memory_budget_bytes are re-shuffled as child ShuffleJobs
    (see the module docstring). With both knobs at their defaults this
    is exactly shuffle/sort.sort_shuffle_job. `num_workers` is the W of
    the round-1 device sort, `device` where it runs. Execution args
    (workers/cluster/worker_list/fleet) pass through to every round's
    job.run; validate the final output with
    data/valsort.validate_from_store on plan.output_prefix, unchanged.
    """
    from repro_torch.shuffle.sort import (DeviceMergeReduceOp, MergeReduceOp,
                                    SortMapOp)

    plan.validate()
    parts = int(num_workers) * plan.reducers_per_worker
    tracer = tracer if tracer is not None else Tracer(job="recursive-sort")
    budget = plan.reduce_memory_budget_bytes
    rb = plan.record_bytes
    rprefix = recurse_prefix(plan)
    _clear_prefix(store, bucket, rprefix)

    # --- sample phase (its own traced/billed phase, see job.py) ---------
    samp = None
    bounds = None
    est = None
    if plan.sample_fraction > 0:
        samp = sample_boundaries(
            store, bucket, input_prefix=plan.input_prefix,
            payload_words=plan.payload_words,
            sample_fraction=plan.sample_fraction, parts=parts,
            tracer=tracer)
        bounds = samp.boundaries
        est = samp.partition_records()

    # --- round 1: the device-path job, with predicted redirects ---------
    def stage_key(path: str) -> str:
        return f"{rprefix}{path}/in/part-00000"

    def path_of(j: int) -> str:
        return f"part-{j:05d}"

    redirect: dict[int, str] = {}
    if budget > 0 and plan.max_rounds > 1 and est is not None:
        redirect = {j: stage_key(path_of(j)) for j in range(parts)
                    if int(est[j]) * rb > budget}
        for j in sorted(redirect):
            tracer.instant("recursive.redirect", ctx=tracer.root,
                           path=path_of(j), predicted_records=int(est[j]))

    map_op = SortMapOp(plan, num_workers, boundaries=bounds, device=device)
    base_op = (DeviceMergeReduceOp(plan, map_op)
               if getattr(plan, "reduce_merge_impl", "numpy") == "device"
               else MergeReduceOp(plan, map_op))
    reduce_op = RedirectReduceOp(base_op, redirect, parts)
    partitioner = RangePartitioner(parts, boundaries=bounds)
    job = ShuffleJob(store, bucket, plan=plan, map_op=map_op,
                     reduce_op=reduce_op, partitioner=partitioner,
                     tracer=tracer)
    rep1 = _run_job(job, workers=workers, cluster=cluster,
                    worker_list=worker_list, fleet=fleet)
    tracer.instant("recursive.round", ctx=tracer.root, depth=1, path="",
                   partitions=parts, redirected=len(redirect))
    rounds: list = [(1, "", rep1)]
    recursed: list[str] = []
    restaged: list[str] = []

    # Key range of each round-1 partition (for child routing).
    full_bounds = np.asarray(partitioner.boundaries(), np.uint64)
    key_lo = np.concatenate(([0], full_bounds))
    key_hi = np.concatenate((full_bounds, [1 << 32]))

    frontier: list[_Item] = []

    def stage_item(path: str, key: str, lo64: int, hi64: int,
                   depth: int) -> None:
        n = (store.head(bucket, key).size - rec.HEADER_BYTES) // rb
        if n == 0:
            store.delete(bucket, key)
            return
        recursed.append(path)
        frontier.append(_Item(path=path, in_prefix=f"{rprefix}{path}/in/",
                              lo64=lo64, hi64=hi64, records=n, depth=depth))

    def observe_and_restage(out_key: str, path: str, lo64: int, hi64: int,
                            depth: int) -> None:
        """A committed (merged) output the round measured oversized:
        copy it to staging, drop the original, recurse. The copy is the
        price of a sampler miss — predicted redirects never pay it."""
        try:
            meta = store.head(bucket, out_key)
        except KeyError:
            return  # empty partitions may legitimately not exist
        if (meta.size - rec.HEADER_BYTES) <= budget:
            return
        skey = stage_key(path)
        store.put(bucket, skey, store.get(bucket, out_key),
                  metadata={"restaged_from": out_key})
        store.delete(bucket, out_key)
        restaged.append(path)
        tracer.instant("recursive.restage", ctx=tracer.root, path=path,
                       nbytes=meta.size)
        stage_item(path, skey, lo64, hi64, depth)

    for j in sorted(redirect):
        stage_item(path_of(j), redirect[j], int(key_lo[j]) << 32,
                   int(key_hi[j]) << 32, depth=2)
    if budget > 0 and plan.max_rounds > 1:
        for j in range(parts):
            if j in redirect:
                continue
            observe_and_restage(base_op.output_key(j), path_of(j),
                                int(key_lo[j]) << 32, int(key_hi[j]) << 32,
                                depth=2)

    # --- rounds 2..max_rounds: child jobs over the staged partitions ----
    while frontier:
        item = frontier.pop(0)
        deeper = item.depth < plan.max_rounds
        child_plan = dataclasses.replace(
            plan,
            input_prefix=item.in_prefix,
            spill_prefix=f"{rprefix}{item.path}/spill/",
            output_prefix=f"{plan.output_prefix}{item.path}/",
        )
        route = KeyRoute(lo64=item.lo64, hi64=item.hi64)
        # Target each sub-partition at ~half the budget so a modest
        # estimate error doesn't immediately trigger another round.
        sub_parts = max(2, -(-item.records * rb // max(budget // 2, 1)))
        cest = None
        if plan.sample_fraction > 0:
            csamp = sample_boundaries(
                store, bucket, input_prefix=child_plan.input_prefix,
                payload_words=plan.payload_words,
                sample_fraction=plan.sample_fraction, parts=sub_parts,
                tracer=tracer, route=route.routed)
            cbounds = csamp.boundaries
            cest = csamp.partition_records()
        else:
            cbounds = route.equal_bounds(sub_parts)
        credirect: dict[int, str] = {}
        if deeper and cest is not None:
            credirect = {
                q: stage_key(f"{item.path}/sub-{q:05d}")
                for q in range(sub_parts) if int(cest[q]) * rb > budget}
        sub_partitioner = SubrangePartitioner(sub_parts, route, cbounds)
        cmap = SubrangeSortMapOp(child_plan, sub_partitioner)
        creduce = RedirectReduceOp(SubrangeMergeReduceOp(child_plan, cmap),
                                   credirect, sub_parts)
        child = ShuffleJob(store, bucket, plan=child_plan, map_op=cmap,
                           reduce_op=creduce, partitioner=sub_partitioner,
                           tracer=tracer)
        crep = _run_job(child, workers=workers, cluster=cluster,
                        worker_list=worker_list, fleet=fleet)
        tracer.instant("recursive.round", ctx=tracer.root, depth=item.depth,
                       path=item.path, partitions=sub_parts,
                       redirected=len(credirect))
        rounds.append((item.depth, item.path, crep))
        for q in sorted(credirect):
            lo64, hi64 = route.sub_range64(cbounds, q)
            stage_item(f"{item.path}/sub-{q:05d}", credirect[q], lo64, hi64,
                       depth=item.depth + 1)
        if deeper:
            for q in range(sub_parts):
                if q in credirect:
                    continue
                lo64, hi64 = route.sub_range64(cbounds, q)
                observe_and_restage(
                    f"{child_plan.output_prefix}sub-{q:05d}",
                    f"{item.path}/sub-{q:05d}", lo64, hi64,
                    depth=item.depth + 1)

    _clear_prefix(store, bucket, rprefix)
    return RecursiveSortReport(
        rounds=rounds, sample=samp, recursed=recursed, restaged=restaged,
        output_objects=len(store.list_objects(bucket, plan.output_prefix)),
    )


__all__ = ["KeyRoute", "RecursiveSortReport", "RedirectReduceOp",
           "SubrangeMergeReduceOp", "SubrangePartitioner",
           "SubrangeSortMapOp", "recursive_sort", "recurse_prefix"]
