"""Streaming group-by aggregation: the second workload, proving the API.

Word-count in CloudSort clothing: input objects hold (group key, id,
value) records; the job aggregates per-group contribution counts and
value sums. Everything sort-specific is absent from these operators —
no device mesh, no gensort layout, no k-way-merge-into-sorted-partitions
contract — yet the workload runs on the identical staging, tiered/faulty
store, budget-governor, and fault-recovery machinery, because those live
in the library (shuffle/runtime.py, shuffle/executor.py), not in the
workload. That is the Exoshuffle claim, made executable.

Dataflow:

  map     — one task per input object: route keys through a
      HashPartitioner (group keys are usually skewed — word
      frequencies — so uniform routing needs a hash), sort the split by
      (partition, key), normalize every record to (key, count, sum) =
      (key, 1, value), optionally collapse equal keys map-side
      (SumCombineOp — the combiner; repeated keys then cost one spilled
      record instead of many), and spill ONE run per task whose
      partition offsets ride in the object metadata (store-recoverable,
      like the sort's spill contract).

  reduce  — partition r streams its slice of every task's run through
      the library's bounded cursors; runs are key-sorted within a
      partition slice, so the scheduler's merge windows arrive in key
      order and the sink aggregates contiguous equal keys with a
      carry for groups straddling window boundaries. Output records are
      unique keys in ascending order: (key, total count, total sum).
      The record count is only known at the end, so the sink defers the
      16-byte header to multipart part 0 and streams body parts from
      index 1 — the out-of-order part-indexed upload contract at work.

Determinism: aggregation is commutative/associative (u32 wrap-around
included), records route by key alone, and output keys are emitted in
sorted unique order — so output bytes are identical at any parallelism,
any worker count, under worker kills, and with the combiner on or off
(only the *spill* bytes shrink). tests/test_shuffle.py asserts all four.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io.backends import StoreBackend

from repro_torch.shuffle.api import (CombineOp, MapOp, Partitioner,
                               PartitionReducer, ReduceOp, ShufflePlan,
                               require)
from repro_torch.shuffle.job import ShuffleJob
from repro_torch.shuffle.partition import HashPartitioner, _splitmix32
from repro_torch.shuffle.runtime import merge_fragments, timed_put

_U32 = np.uint64(0xFFFFFFFF)


def _group_starts(keys: np.ndarray) -> np.ndarray:
    """Start index of each contiguous equal-key group."""
    if keys.size == 0:
        return np.empty((0,), np.int64)
    return np.flatnonzero(
        np.concatenate(([True], keys[1:] != keys[:-1]))).astype(np.int64)


class SumCombineOp(CombineOp):
    """The word-count combiner: collapse contiguous equal keys, summing
    contribution counts (the id field) and values (payload word 0) with
    u32 wrap-around — the same arithmetic the reduce side applies, so
    combining is invisible in the output bytes."""

    def combine(self, keys: np.ndarray, ids: np.ndarray,
                payload: np.ndarray | None):
        starts = _group_starts(keys)
        if starts.size == keys.size:  # nothing to collapse
            return keys, ids, payload
        uk = keys[starts]
        counts = np.add.reduceat(ids.astype(np.uint64), starts)
        sums = np.add.reduceat(payload[:, 0].astype(np.uint64), starts)
        return (uk,
                (counts & _U32).astype(np.uint32),
                (sums & _U32).astype(np.uint32).reshape(-1, 1))


class GroupByMapOp(MapOp):
    """One map task per input object: route, sort, normalize, combine,
    spill one partition-offset-indexed run."""

    num_mesh_workers = 1  # pure host/numpy workload
    spill_objects_per_task = 1

    def __init__(self, plan: ShufflePlan, partitioner: Partitioner,
                 combiner: CombineOp | None = None):
        require(plan.payload_words == 1, "payload_words", plan.payload_words,
                "group-by records carry exactly one value word "
                "(payload[0] = the aggregated sum)")
        self.plan = plan
        self.partitioner = partitioner
        self.combiner = combiner
        self.partition_offsets: dict[int, np.ndarray] = {}
        self._objs: list = []

    def run_key(self, task: int) -> str:
        return f"{self.plan.spill_prefix}run-{task:05d}"

    def spill_keys(self, task: int) -> list[str]:
        return [self.run_key(task)]  # lineage for elastic spill loss

    def plan_tasks(self, store: StoreBackend, bucket: str) -> int:
        plan = self.plan
        inputs = store.list_objects(bucket, plan.input_prefix)
        if not inputs:
            raise ValueError(
                f"input_prefix={plan.input_prefix!r}: no input objects")
        counts = [(m.size - rec.HEADER_BYTES) // plan.record_bytes
                  for m in inputs]
        self._objs = inputs
        self.total_records = sum(counts)
        self.working_set_records = max(counts)
        return len(inputs)

    def load(self, store: StoreBackend, bucket: str, task: int):
        plan = self.plan
        meta = self._objs[task]
        n = (meta.size - rec.HEADER_BYTES) // plan.record_bytes
        rows = rec.alloc_rows(n, plan.payload_words)
        dec = rec.StreamDecoder(rows, 0, what=meta.key)
        for chunk in store.get_chunks(bucket, meta.key,
                                      plan.store_chunk_bytes):
            dec.feed(chunk)
        dec.finish()
        return rec.split_rows(rows)

    def process(self, store: StoreBackend, bucket: str, task: int, data, *,
                spiller, timeline, tag) -> None:
        keys, _ids, payload = data  # raw ids die at normalization below
        t_comp = time.perf_counter()
        parts = self.partitioner.partition_of(keys)
        order = np.lexsort((keys, parts))
        sk = np.ascontiguousarray(keys[order])
        svals = np.ascontiguousarray(payload[order])
        # Normalize to (key, count, sum): every raw record contributes
        # count 1; the combiner (if any) then collapses equal keys so
        # repeated keys cost one spilled record, not many.
        scounts = np.ones(sk.shape, np.uint32)
        sparts = parts[order]  # already routed — don't re-hash the split
        if self.combiner is not None:
            n_before = sk.shape[0]
            sk, scounts, svals = self.combiner.combine(sk, scounts, svals)
            if sk.shape[0] != n_before:
                # A pluggable combiner only promises collapsed records,
                # not index correspondence — re-route the (much smaller)
                # collapsed span.
                sparts = self.partitioner.partition_of(sk)
        offsets = np.searchsorted(
            sparts, np.arange(self.partitioner.num_partitions + 1),
            side="left").astype(np.int64)
        self.partition_offsets[task] = offsets
        encoded = rec.encode_records(sk, scounts, svals)
        timeline.add("map.compute", t_comp, worker=tag)
        t_spill = time.perf_counter()
        spiller.submit(timed_put, timeline, tag, store, bucket,
                       self.run_key(task), encoded, {
                           "records": int(sk.shape[0]),
                           "task": task,
                           "partition_offsets": [int(o) for o in offsets],
                       })
        timeline.add("map.spill_wait", t_spill, worker=tag)


class _GroupAggSink(PartitionReducer):
    """Streaming aggregation of key-sorted merge windows.

    Equal keys are contiguous within a window (the scheduler merges
    fragments by packed key) but one group may straddle windows, so the
    last group of every non-final window is carried into the next. The
    output record count is unknown until the carry flushes, hence the
    deferred part-0 header.
    """

    deferred_part0 = True

    def __init__(self, payload_words: int):
        self._pw = int(payload_words)
        self._carry: tuple[int, int, int] | None = None  # (key, count, sum)
        self._emitted = 0

    def begin(self) -> bytes:
        return b""

    def _aggregate(self, keys, counts, sums, *, final: bool):
        starts = _group_starts(keys)
        uk = keys[starts].astype(np.uint64)
        uc = np.add.reduceat(counts.astype(np.uint64), starts) \
            if starts.size else np.empty((0,), np.uint64)
        us = np.add.reduceat(sums.astype(np.uint64), starts) \
            if starts.size else np.empty((0,), np.uint64)
        if self._carry is not None:
            ck, cc, cs = self._carry
            if uk.size and int(uk[0]) == ck:
                uc[0] += cc
                us[0] += cs
            else:
                # Explicit uint64 operands: a bare [int] + uint64-array
                # concatenate promotes to float64, silently rounding
                # accumulators above 2^53.
                uk = np.concatenate((np.array([ck], np.uint64), uk))
                uc = np.concatenate((np.array([cc], np.uint64), uc))
                us = np.concatenate((np.array([cs], np.uint64), us))
            self._carry = None
        if not final and uk.size:
            self._carry = (int(uk[-1]), int(uc[-1]), int(us[-1]))
            uk, uc, us = uk[:-1], uc[:-1], us[:-1]
        if not uk.size:
            return b""
        self._emitted += int(uk.size)
        return rec.encode_body(
            uk.astype(np.uint32),
            (uc & _U32).astype(np.uint32),
            (us & _U32).astype(np.uint32).reshape(-1, 1))

    def consume(self, frags, *, final: bool) -> bytes:
        mk, mi, mp = merge_fragments(frags, self._pw)
        sums = mp[:, 0] if mk.size else np.empty((0,), np.uint32)
        return self._aggregate(mk, mi, sums, final=final)

    def finalize(self) -> tuple[bytes, bytes | None]:
        tail = b""
        if self._carry is not None:  # defensive: final consume flushes it
            ck, cc, cs = self._carry
            self._carry = None
            self._emitted += 1
            tail = rec.encode_body(
                np.array([ck], np.uint32),
                np.array([cc & 0xFFFFFFFF], np.uint32),
                np.array([[cs & 0xFFFFFFFF]], np.uint32))
        return tail, rec.encode_header(self._emitted, self._pw)


class GroupByReduceOp(ReduceOp):
    """Partition r streams its slice of every task's run into one
    aggregated, key-sorted output object."""

    def __init__(self, plan: ShufflePlan, map_op: GroupByMapOp):
        self.plan = plan
        self.map_op = map_op
        self.payload_words = plan.payload_words

    def sources(self, r: int) -> tuple[list[tuple[str, int, int]], int]:
        map_op = self.map_op
        slices, n_total = [], 0
        for g in range(len(map_op._objs)):
            offs = map_op.partition_offsets[g]
            lo, hi = int(offs[r]), int(offs[r + 1])
            if hi > lo:
                slices.append((map_op.run_key(g), lo, hi))
                n_total += hi - lo
        return slices, n_total

    def output_key(self, r: int) -> str:
        return f"{self.plan.output_prefix}agg-{r:05d}"

    def output_metadata(self, r: int, n_total: int) -> dict:
        return {"partition": r, "input_records": n_total}

    def open(self, r: int, n_total: int) -> PartitionReducer:
        return _GroupAggSink(self.payload_words)


def groupby_job(store: StoreBackend, bucket: str, *, plan: ShufflePlan,
                num_partitions: int, combine: bool = True,
                tracer=None) -> ShuffleJob:
    """Build the group-by ShuffleJob: hash-routed keyed aggregation with
    an optional map-side combiner. `tracer` as in sort_shuffle_job."""
    partitioner = HashPartitioner(num_partitions)
    map_op = GroupByMapOp(plan, partitioner,
                          combiner=SumCombineOp() if combine else None)
    reduce_op = GroupByReduceOp(plan, map_op)
    return ShuffleJob(store, bucket, plan=plan, map_op=map_op,
                      reduce_op=reduce_op, partitioner=partitioner,
                      tracer=tracer)


# ---------------------------------------------------------------------------
# Synthetic skewed input + streaming validation (the workload's gensort
# and valsort analogues).
# ---------------------------------------------------------------------------

_VALUE_SALT = np.uint32(0x7F4A7C15)


def write_groupby_input(store: StoreBackend, bucket: str, prefix: str,
                        total_records: int, records_per_partition: int, *,
                        num_groups: int, skew: float = 1.0,
                        value_range: int = 8):
    """Deterministic skewed keyed input, written through the store.

    Record i: group key = floor(num_groups * u^skew) with
    u = splitmix32(i) / 2^32 (skew > 1 concentrates mass on low group
    ids — the word-frequency shape), value = splitmix32(i ^ salt) in
    [1, value_range]. Reproducible from the parameters alone, like
    gensort. Returns (expected_counts, expected_sums) uint64 arrays of
    length num_groups — the reference the streaming validator checks
    against (mod 2^32, the output's wrap-around arithmetic).
    """
    require(total_records % records_per_partition == 0, "total_records",
            total_records, "must tile records_per_partition exactly")
    require(num_groups >= 1, "num_groups", num_groups, "must be >= 1")
    require(skew > 0, "skew", skew, "must be > 0")
    for meta in store.list_objects(bucket, prefix):
        store.delete(bucket, meta.key)
    expected_counts = np.zeros(num_groups, np.uint64)
    expected_sums = np.zeros(num_groups, np.uint64)
    num_parts = total_records // records_per_partition
    for p in range(num_parts):
        ids = np.arange(p * records_per_partition,
                        (p + 1) * records_per_partition, dtype=np.uint32)
        u = _splitmix32(ids).astype(np.float64) / float(1 << 32)
        groups = np.minimum(
            (num_groups * np.power(u, skew)).astype(np.int64),
            num_groups - 1)
        values = _splitmix32(ids ^ _VALUE_SALT) % np.uint32(value_range) \
            + np.uint32(1)
        np.add.at(expected_counts, groups, 1)
        np.add.at(expected_sums, groups, values.astype(np.uint64))
        data = rec.encode_records(groups.astype(np.uint32), ids,
                                  values.reshape(-1, 1))
        store.put(bucket, f"{prefix}part-{p:05d}", data,
                  metadata={"records": records_per_partition})
    return expected_counts, expected_sums


@dataclasses.dataclass
class GroupByValidation:
    """The three group-by gates: sorted unique keys, correct routing,
    and exact aggregates (counts and sums, mod 2^32)."""

    total_groups: int
    input_records: int  # sum of output counts (mod 2^32)
    keys_sorted_unique: bool
    routing_ok: bool
    counts_match: bool
    sums_match: bool

    @property
    def ok(self) -> bool:
        return (self.keys_sorted_unique and self.routing_ok
                and self.counts_match and self.sums_match)


def validate_groupby_from_store(store: StoreBackend, bucket: str,
                                prefix: str, partitioner: Partitioner,
                                expected_counts: np.ndarray,
                                expected_sums: np.ndarray, *,
                                chunk_records: int = 1 << 13
                                ) -> GroupByValidation:
    """Stream the aggregated output back out of the store and check it
    against the generation-time reference — never holding more than
    `chunk_records` decoded records (the valsort discipline)."""
    num_groups = int(expected_counts.shape[0])
    got_counts = np.zeros(num_groups, np.uint64)
    got_sums = np.zeros(num_groups, np.uint64)
    keys_sorted_unique = True
    routing_ok = True
    total_groups = 0
    for meta in store.list_objects(bucket, prefix):
        r = int(meta.key.rsplit("-", 1)[1])
        n, pw = rec.decode_header(
            store.get_range(bucket, meta.key, 0, rec.HEADER_BYTES))
        prev_last = None
        for lo in range(0, n, chunk_records):
            cnt = min(chunk_records, n - lo)
            start, length = rec.body_range(lo, cnt, pw)
            k, c, s = rec.decode_body(
                store.get_range(bucket, meta.key, start, length), pw)
            if k.size:
                if not bool(np.all(k[1:] > k[:-1])):
                    keys_sorted_unique = False
                if prev_last is not None and int(k[0]) <= prev_last:
                    keys_sorted_unique = False
                prev_last = int(k[-1])
                if not bool(np.all(partitioner.partition_of(k) == r)):
                    routing_ok = False
                if int(k.max()) >= num_groups:
                    routing_ok = False
                    continue
            np.add.at(got_counts, k.astype(np.int64), c.astype(np.uint64))
            np.add.at(got_sums, k.astype(np.int64),
                      s[:, 0].astype(np.uint64))
            total_groups += int(k.size)
    counts_match = bool(np.array_equal(got_counts & _U32,
                                       expected_counts & _U32))
    sums_match = bool(np.array_equal(got_sums & _U32,
                                     expected_sums & _U32))
    return GroupByValidation(
        total_groups=total_groups,
        input_records=int(got_counts.sum() & _U32),
        keys_sorted_unique=keys_sorted_unique,
        routing_ok=routing_ok,
        counts_match=counts_match,
        sums_match=sums_match,
    )


__all__ = [
    "GroupByMapOp",
    "GroupByReduceOp",
    "GroupByValidation",
    "SumCombineOp",
    "groupby_job",
    "validate_groupby_from_store",
    "write_groupby_input",
]
