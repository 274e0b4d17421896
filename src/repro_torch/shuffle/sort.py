"""CloudSort as a ShuffleJob: the sort, re-expressed as one instantiation.

Port of src/repro/shuffle/sort.py. A MapOp loads a wave of input objects
and sorts it on the device into range-partitioned spill runs (wrapping
core/external_sort.WaveSorter), and a ReduceOp whose PartitionReducer is
a streaming k-way merge — the numpy `merge_fragments` on the host, or the
kernels/kway_merge tournament on the device. Output bytes are
byte- and etag-identical to the reference's at any parallelism, worker
count, and under worker kills.

The W mesh workers of the reference are a batch axis here: W is the
`num_workers` argument (it shapes the spill runs and reducer offsets),
not a device count. With a launch/mesh.RankMesh each of G ranks holds
W/G of them: every rank runs every wave's device step (the wave is one
SPMD program across ranks), spills its workers' runs, and reduces the
partitions of its workers on its own card.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.io import records as rec
from repro_torch.io.backends import StoreBackend

from repro_torch.shuffle.api import MapOp, PartitionReducer, ReduceOp
from repro_torch.shuffle.job import ShuffleJob
from repro_torch.shuffle.partition import RangePartitioner
from repro_torch.shuffle.runtime import merge_fragments


class SortMapOp(MapOp):
    """Map side of CloudSort: load one wave zero-copy, sort it across the
    W batched workers on `device`, spill one range-partitioned run per
    worker (with per-reducer offsets in the spill metadata)."""

    def __init__(self, plan, num_workers: int, boundaries=None,
                 device="cuda", mesh=None):
        from repro_torch.core import external_sort as xs

        self.plan = plan
        self.sorter = xs.WaveSorter(plan, num_workers, boundaries=boundaries,
                                    device=device, mesh=mesh)
        self.num_mesh_workers = self.sorter.w
        self.spill_objects_per_task = self.sorter.wl
        self.spill_offsets: dict[tuple[int, int], np.ndarray] = {}
        self.waves: list = []

    def plan_tasks(self, store: StoreBackend, bucket: str) -> int:
        from repro_torch.core import external_sort as xs

        plan = self.plan
        inputs = store.list_objects(bucket, plan.input_prefix)
        if not inputs:
            raise ValueError(
                f"input_prefix={plan.input_prefix!r}: no input objects")
        counts = [(m.size - rec.HEADER_BYTES) // plan.record_bytes
                  for m in inputs]
        self.waves = xs._group_waves(inputs, counts, plan.records_per_wave)
        self.total_records = sum(counts)
        self.working_set_records = plan.records_per_wave
        return len(self.waves)

    def load(self, store: StoreBackend, bucket: str, task: int):
        return self.sorter.load_wave(store, bucket, self.waves[task])

    def spill_keys(self, task: int) -> list[str]:
        from repro_torch.core import external_sort as xs

        return [xs._spill_key(self.plan, task, wid)
                for wid in self.sorter.worker_ids]

    def process(self, store: StoreBackend, bucket: str, task: int, data, *,
                spiller, timeline, tag) -> None:
        keys, ids, payload = data
        self.sorter.compute_and_spill(
            store, bucket, task, keys, ids, payload, spiller=spiller,
            timeline=timeline, tag=tag, offsets_out=self.spill_offsets)

    # Staged map interface (the pipelined executor, active when
    # plan.map_pipeline is true): the same body as process(), split at
    # the device boundary so wave N's sort overlaps wave N-1's encode.
    def device_step(self, task: int, data, *, timeline, tag):
        keys, ids, payload = data
        return data, self.sorter.device_sort(keys, ids, payload,
                                             timeline=timeline, tag=tag)

    def encode_step(self, store: StoreBackend, bucket: str, task: int,
                    staged, *, spiller, timeline, tag) -> None:
        (keys, ids, payload), (sk, si, vcounts, rows) = staged
        self.sorter.encode_and_spill(
            store, bucket, task, sk, si, vcounts, ids, payload,
            spiller=spiller, timeline=timeline, tag=tag,
            offsets_out=self.spill_offsets, rows=rows)


class _SortMergeSink(PartitionReducer):
    """Streaming k-way merge on the host: the record count is known up
    front, so the header streams first and sorted body chunks follow."""

    deferred_part0 = False

    def __init__(self, n_total: int, payload_words: int):
        self._n = int(n_total)
        self._pw = int(payload_words)

    def begin(self) -> bytes:
        return rec.encode_header(self._n, self._pw)

    def consume(self, frags, *, final: bool) -> bytes:
        mk, mi, mp = merge_fragments(frags, self._pw)
        return rec.encode_body(mk, mi, mp) if mk.size else b""


class _DeviceMergeSink(PartitionReducer):
    """Device k-way merge, double-buffered.

    Same byte STREAM as _SortMergeSink, shifted one cycle: consume()
    hands the emit window to a one-thread merge+encode stage
    (kernels/kway_merge.merge_fragments_device — bit-identical to the
    numpy merge) and returns the PREVIOUS window's encoded bytes, so
    window i's merge overlaps window i+1's ranged-GET fetches; finalize()
    flushes the last window. A merge failure surfaces on the next
    consume()/finalize().
    """

    deferred_part0 = False

    def __init__(self, n_total: int, payload_words: int, *,
                 impl: str = "kernel", device="cuda"):
        self._n = int(n_total)
        self._pw = int(payload_words)
        self._impl = impl
        self._device = device
        self._timeline = None
        self._tag = ""
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="device-merge")
        self._pending = None

    def bind_exec(self, *, timeline, tag: str) -> None:
        # Optional sink hook the ReduceScheduler calls right after open():
        # stage-thread work records reduce.device_merge spans.
        self._timeline = timeline
        self._tag = tag

    def begin(self) -> bytes:
        return rec.encode_header(self._n, self._pw)

    def _merge_encode(self, frags) -> bytes:
        from repro_torch.kernels.kway_merge import merge_fragments_device

        t = time.perf_counter()
        mk, mi, mp = merge_fragments_device(frags, self._pw,
                                            impl=self._impl,
                                            device=self._device)
        body = rec.encode_body(mk, mi, mp) if mk.size else b""
        if self._timeline is not None:
            self._timeline.add("reduce.device_merge", t, worker=self._tag)
        return body

    def consume(self, frags, *, final: bool) -> bytes:
        job = self._pool.submit(self._merge_encode, frags)
        prev, self._pending = self._pending, job
        if prev is None:
            return b""
        try:
            return prev.result()
        except BaseException:
            self._pool.shutdown(wait=False)
            raise

    def finalize(self):
        try:
            tail = b"" if self._pending is None else self._pending.result()
        finally:
            self._pool.shutdown(wait=True)
        return tail, None


class MergeReduceOp(ReduceOp):
    """Reduce side of CloudSort: partition r streams its slice of every
    spilled run (located by the offsets the map side recorded) through a
    k-way merge into a multipart-uploaded output partition."""

    def __init__(self, plan, map_op: SortMapOp):
        self.plan = plan
        self.map_op = map_op
        self.payload_words = plan.payload_words

    def sources(self, r: int) -> tuple[list[tuple[str, int, int]], int]:
        from repro_torch.core import external_sort as xs

        plan, map_op = self.plan, self.map_op
        wid, j = divmod(r, map_op.sorter.r1)
        if wid not in map_op.sorter.worker_ids:
            raise ValueError(f"partition {r} belongs to worker {wid}, "
                             "which this rank does not hold")
        slices, n_total = [], 0
        for g in range(len(map_op.waves)):
            offs = map_op.spill_offsets[(g, wid)]
            lo, hi = int(offs[j]), int(offs[j + 1])
            if hi > lo:
                slices.append((xs._spill_key(plan, g, wid), lo, hi))
                n_total += hi - lo
        return slices, n_total

    def output_key(self, r: int) -> str:
        from repro_torch.core import external_sort as xs

        return xs._output_key(self.plan, r)

    def output_metadata(self, r: int, n_total: int) -> dict:
        return {"records": n_total, "reducer": r}

    def open(self, r: int, n_total: int) -> PartitionReducer:
        return _SortMergeSink(n_total, self.payload_words)


class DeviceMergeReduceOp(MergeReduceOp):
    """MergeReduceOp with the device, double-buffered merge sink
    (_DeviceMergeSink) — selected by plan.reduce_merge_impl="device".
    Sources, output keys, chunk sizing and output bytes are identical to
    the numpy backend; only where the window merge runs changes.

    As in the reference, a "ref" plan still merges through the kernel
    path: the sort oracle would only be slower, and all versions are
    pinned bit-identical."""

    def open(self, r: int, n_total: int) -> PartitionReducer:
        impl = "kernel" if self.plan.impl == "ref" else self.plan.impl
        return _DeviceMergeSink(n_total, self.payload_words, impl=impl,
                                device=self.map_op.sorter.device)


def sort_shuffle_job(store: StoreBackend, bucket: str, *, num_workers: int,
                     plan, tracer=None, boundaries=None,
                     device="cuda", mesh=None) -> ShuffleJob:
    """Build the CloudSort ShuffleJob: SortMapOp + MergeReduceOp (or
    DeviceMergeReduceOp, per plan.reduce_merge_impl) over an
    order-preserving range partitioner, sorting on `device` ("cuda"
    raises without a Hopper card; "cpu" runs the plain versions). Run
    with `job.run(workers=N[, cluster=ClusterPlan(...)])`. `boundaries`
    replaces the equal key split with W*R1-1 explicit reducer boundaries;
    the same values feed the host RangePartitioner and the device
    routing. With a `mesh` (launch/mesh.RankMesh) every rank builds the
    same job and runs it with `job.run()`; the sort runs on the mesh's
    device and each rank returns the report gathered from all of them."""
    map_op = SortMapOp(plan, num_workers, boundaries=boundaries,
                       device=device, mesh=mesh)
    if getattr(plan, "reduce_merge_impl", "numpy") == "device":
        reduce_op: MergeReduceOp = DeviceMergeReduceOp(plan, map_op)
    else:
        reduce_op = MergeReduceOp(plan, map_op)
    partitioner = RangePartitioner(map_op.sorter.w * map_op.sorter.r1,
                                   boundaries=boundaries)
    return ShuffleJob(store, bucket, plan=plan, map_op=map_op,
                      reduce_op=reduce_op, partitioner=partitioner,
                      tracer=tracer, mesh=mesh)


__all__ = ["DeviceMergeReduceOp", "MergeReduceOp", "SortMapOp",
           "sort_shuffle_job"]
