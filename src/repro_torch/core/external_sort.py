"""Out-of-core external sort: the dataset lives in the object store, and
the card holds one map wave.

Port of src/repro/core/external_sort.py — the CloudSort *workload*: the
wave/spill layout, the map body (WaveSorter) and the ExternalSortPlan
schedule. The generic machinery (span timelines, job control, the
adaptive budget governor, streaming run cursors, the reduce scheduler,
the staged map loop, the drivers) is the shuffle library
(repro_torch/shuffle/), and the sort is one instantiation of it:

    from repro_torch.shuffle.sort import sort_shuffle_job
    report = sort_shuffle_job(store, bucket, num_workers=8, plan=plan,
                              device="cuda").run(workers=N)

Paper mapping:

  map waves (§2.3, §2.5): input partitions stream from the store in ranged
      chunks, decoded zero-copy into one preallocated interleaved-row
      buffer; each wave runs the two-stage streaming exoshuffle
      (core/streaming.py) on the card, after which each of the W batched
      workers holds one range-partitioned sorted run. Payload rows of
      shuffled records are located by O(1) id-offset arithmetic.

  ranks (launch/mesh.RankMesh): G processes, one card each, split the W
      workers; each loads only its workers' records of a wave, the
      streaming sort's all_to_alls cross ranks, the payload rows follow
      by core/payload.late_fetch_payload on the card, and each rank
      spills only its workers' runs, under their global ids — the spill
      objects are the one-process run's, name for name and byte for
      byte.

  spill (§2.3): each worker's run is written under plan.spill_prefix as
      one sorted run object with its per-reducer offsets in the object's
      metadata; write-behind via io/staging.AsyncWriter.

  reduce (§2.4): up to plan.parallel_reducers streaming k-way merges run
      concurrently per worker (shuffle/runtime.ReduceScheduler driving
      shuffle/sort.MergeReduceOp), each streaming merged bytes into an
      incremental multipart upload.

The plan knobs and their invariants are the reference's; see its module
docstring for the reduce-side memory contract.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.collectives import any_across
from repro_torch.core.exoshuffle import ShuffleConfig
from repro_torch.core.payload import late_fetch_payload
from repro_torch.core.streaming import streaming_sort
from repro_torch.io import records as rec
from repro_torch.io import staging
from repro_torch.io.backends import StoreBackend
from repro_torch.kernels import u32
from repro_torch.shuffle import runtime as _rt
from repro_torch.shuffle.api import require, validate_dataflow_plan

PhaseTimeline = _rt.PhaseTimeline
_timed_spill = _rt.timed_put


@dataclasses.dataclass(frozen=True)
class ExternalSortPlan:
    """Out-of-core schedule: what fits on the card and how the store is
    laid out.

    records_per_wave is the device-resident working set — the analogue of
    the paper's (map tasks in flight) x (2 GB block) bound.
    merge_chunk_bytes caps the per-run fetch granularity of the streaming
    merge; with reduce_memory_budget_bytes set, the global budget is
    apportioned across the parallel_reducers concurrent merges by the
    adaptive governor. map_pipeline overlaps each wave's host decode,
    device sort and spill encode across tasks; the spill bytes are the
    same either way. reduce_merge_impl selects the emit-window merge:
    "numpy" is the host argsort merge; "device" runs the
    kernels/kway_merge tournament on a one-thread merge stage,
    double-buffered (byte/etag-identical output). `impl` selects the map
    sort: "kernel" (the CUDA kernels on the card, their plain versions on
    the CPU) or "ref" (the torch oracles).
    """

    records_per_wave: int  # device working set (records, across workers)
    num_rounds: int = 2  # streaming_sort rounds within a wave
    reducers_per_worker: int = 1  # R1; R = W * R1 output partitions
    payload_words: int = 4  # u32 payload words per record
    impl: str = "kernel"  # kernel implementation ("kernel" | "ref")
    capacity_factor: float = 1.5
    input_prefix: str = "input/"
    spill_prefix: str = "spill/"
    output_prefix: str = "output/"
    input_records_per_partition: int = 1 << 13  # gensort object size
    output_part_records: int = 1 << 13  # multipart-upload part size
    store_chunk_bytes: int = 256 << 10  # map download GET granularity
    merge_chunk_bytes: int = 64 << 10  # reduce per-run fetch granularity (cap)
    prefetch_depth: int = 2  # double buffering
    max_inflight_writes: int = 2  # spill/per-partition part backpressure
    io_retries: int = 2  # staging-level re-reads of a failed wave load
    parallel_reducers: int = 4  # concurrent streaming merges (reduce pool)
    reduce_memory_budget_bytes: int = 0  # global merge budget; 0 = uncapped
    part_upload_fanout: int = 2  # out-of-order part uploads per partition
    map_pipeline: bool = True  # overlap decode/device-sort/encode across waves
    reduce_merge_impl: str = "numpy"  # emit-window merge ("numpy" | "device")
    # Skew-adaptive knobs, consumed by the recursive shuffle
    # (shuffle/recursive.py).
    sample_fraction: float = 0.0  # fraction of input records to sample
    max_rounds: int = 1  # recursive shuffle depth (1 = single pass)

    @property
    def record_bytes(self) -> int:
        return rec.record_bytes(self.payload_words)

    def validate(self) -> None:
        """Worker-count-independent plan validation (ValueError with the
        knob name and value — never an assert). The divisibility checks
        run in WaveSorter, which knows W."""
        validate_dataflow_plan(self)
        require(self.records_per_wave >= 1, "records_per_wave",
                self.records_per_wave, "must hold >= 1 record per wave")
        require(self.num_rounds >= 1, "num_rounds", self.num_rounds,
                "must run >= 1 streaming round per wave")
        require(self.reducers_per_worker >= 1, "reducers_per_worker",
                self.reducers_per_worker, "must be >= 1 (R1)")
        require(self.input_records_per_partition >= 1,
                "input_records_per_partition",
                self.input_records_per_partition, "must be >= 1")
        require(self.capacity_factor > 0, "capacity_factor",
                self.capacity_factor, "must be > 0")
        require(self.impl in ("kernel", "ref"), "impl", self.impl,
                'must be "kernel" (hand-written kernels) or "ref" '
                "(torch oracles)")
        require(self.reduce_merge_impl in ("numpy", "device"),
                "reduce_merge_impl", self.reduce_merge_impl,
                'must be "numpy" (host argsort merge) or "device" '
                "(kernels/kway_merge tournament, double-buffered)")
        require(0.0 <= self.sample_fraction <= 1.0, "sample_fraction",
                self.sample_fraction,
                "must be a fraction of input records in [0, 1]")
        require(self.max_rounds >= 1, "max_rounds", self.max_rounds,
                "must allow >= 1 shuffle round")
        require(self.max_rounds == 1 or self.reduce_memory_budget_bytes > 0,
                "max_rounds", self.max_rounds,
                "recursive rounds need reduce_memory_budget_bytes > 0 — "
                "the budget is the oversize criterion that triggers a "
                "re-shuffle")


def plan_from_reference(fields: dict) -> ExternalSortPlan:
    """An ExternalSortPlan from `dataclasses.asdict` of the reference
    package's plan: impl "pallas" maps to "kernel", "ref" stays "ref"."""
    fields = dict(fields)
    impl = fields.get("impl", "kernel")
    fields["impl"] = {"pallas": "kernel", "ref": "ref"}.get(impl, impl)
    return ExternalSortPlan(**fields)


def _spill_key(plan: ExternalSortPlan, wave: int, worker: int) -> str:
    return f"{plan.spill_prefix}wave-{wave:04d}/w-{worker:03d}"


def _output_key(plan: ExternalSortPlan, reducer: int) -> str:
    return f"{plan.output_prefix}part-{reducer:05d}"


def _group_waves(inputs, counts, records_per_wave: int):
    """Tile the key-ordered input objects into equal-record waves.

    ValueError, not assert: the tiling contract must survive python -O.
    """
    waves, cur, acc = [], [], 0
    for meta, c in zip(inputs, counts):
        cur.append(meta)
        acc += c
        require(acc <= records_per_wave, "records_per_wave",
                records_per_wave,
                "input partitions must tile it exactly "
                f"(partition {meta.key} overflows the wave)")
        if acc == records_per_wave:
            waves.append(cur)
            cur, acc = [], 0
    require(not cur, "records_per_wave", records_per_wave,
            "total input records must be a multiple of it")
    return waves


def _contiguous_id_base(ids: np.ndarray) -> int | None:
    """Base id when a wave's ids are exactly arange(base, base + n).

    gensort assigns ids sequentially across key-ordered input partitions,
    so the payload row of shuffled record id is just (id - base); one
    vectorized equality pass verifies the assumption, and any other id
    layout falls back to the general gather.
    """
    n = ids.size
    if n == 0:
        return None
    base = int(ids[0])
    # Unwrapped comparison on purpose: a range wrapping past 2^32 would
    # break the (id - base) gather below, so it must take the fallback.
    if base + n - 1 != int(ids[-1]):
        return None
    expect = np.uint32(base) + np.arange(n, dtype=np.uint32)
    if not bool(np.array_equal(np.asarray(ids, dtype=np.uint32), expect)):
        return None
    return base


def _validate_plan(plan: ExternalSortPlan, w: int) -> None:
    """Plan validation shared by every sort entry point, including the
    W-dependent divisibility check."""
    plan.validate()
    require(plan.records_per_wave % (w * plan.num_rounds) == 0,
            "records_per_wave", plan.records_per_wave,
            f"must divide evenly into {w} mesh workers x "
            f"{plan.num_rounds} rounds")


class WaveSorter:
    """Map-side building block: load a wave zero-copy, sort it on the
    device across the W batched workers, spill per-worker runs.

    Wrapped by shuffle/sort.SortMapOp. Deterministic by construction: the
    spilled run bytes and reducer offsets depend only on (wave contents,
    plan, W) — never on the device, the scheduler, the cluster worker
    that executes the wave, or how many ranks split it.

    With a `mesh` (launch/mesh.RankMesh, the twin of the reference's
    `mesh, axis_names`) this rank holds workers [lo, lo + W/G): it loads
    their records of each wave, sorts with the other ranks, and spills
    their runs; `device` is then the mesh's.
    """

    def __init__(self, plan: ExternalSortPlan, num_workers: int,
                 boundaries: Sequence[int] | np.ndarray | None = None,
                 device="cuda", mesh=None):
        self.plan = plan
        self.w = int(num_workers)
        self.r1 = plan.reducers_per_worker
        self.pw = plan.payload_words
        self.mesh = mesh
        if mesh is None:
            self.device = u32.resolve_device(device)
            self.wl, self.lo = self.w, 0
        else:
            require(mesh.num_workers == self.w, "num_workers", self.w,
                    f"must be the mesh's ({mesh})")
            self.device = mesh.device
            self.wl, self.lo = mesh.workers_per_rank, mesh.worker_lo
        _validate_plan(plan, self.w)
        # Explicit (sampled) reducer boundaries replace the equal split in
        # BOTH device routing and the host-side reducer_offsets below.
        self.cfg = ShuffleConfig(
            num_workers=self.w,
            reducers_per_worker=self.r1,
            capacity_factor=plan.capacity_factor,
            num_rounds=plan.num_rounds,
            impl=plan.impl,
            boundaries=(None if boundaries is None
                        else tuple(int(b) for b in np.asarray(boundaries))),
        )
        self._local_bounds = (
            u32.to_numpy(self.cfg.keyspace.local_reducer_boundaries("cpu"))
            if self.r1 > 1 else None
        )  # (W, R1-1)
        # The card is ONE shared resource: cluster workers queue on this
        # lock for the sort step and overlap on everything else.
        self._device_lock = threading.Lock()

    @property
    def worker_ids(self) -> range:
        """Global ids of the workers whose runs this sorter spills."""
        return range(self.lo, self.lo + self.wl)

    def load_wave(self, store: StoreBackend, bucket: str, objs):
        """Chunked-GET a wave's input objects into one preallocated
        interleaved-row buffer (zero-copy decode); returns (keys, ids,
        payload). With a mesh, only this rank's records of the wave: an
        object that straddles two ranks is read by ranged GETs, the
        header by the rank that holds its first record, so the bytes read
        summed over ranks are the one-process run's."""
        plan = self.plan
        counts = [(m.size - rec.HEADER_BYTES) // plan.record_bytes
                  for m in objs]
        lo, hi = 0, sum(counts)
        if self.mesh is not None:
            lo, hi = self.mesh.share(hi)
        rows = rec.alloc_rows(hi - lo, self.pw)
        at = base = 0
        for m, c in zip(objs, counts):
            a, b = max(lo - base, 0), min(hi - base, c)
            base += c
            if a >= b:
                continue
            if (a, b) == (0, c):
                dec = rec.StreamDecoder(rows, at, what=m.key)
                for chunk in store.get_chunks(bucket, m.key,
                                              plan.store_chunk_bytes):
                    dec.feed(chunk)
                at += dec.finish()
            else:
                at += _load_records(store, bucket, m, a, b, c, rows, at,
                                    plan.store_chunk_bytes)
        return rec.split_rows(rows)

    def device_sort(self, keys, ids, payload=None, *,
                    timeline: PhaseTimeline | None = None, tag: str = ""):
        """Stage 1 of the map body: the batched sort on the device
        (serialized on the device lock), returned as host numpy copies
        (sk, si, vcounts, rows). `rows` is None without a mesh (the
        encode stage gathers payload rows from the whole wave on the
        host); with one it holds, for each of the rank's workers, the
        (vcounts[i], pw) payload of its sorted records, fetched from the
        ranks that loaded them. With a timeline, the interval is recorded
        under both map.device_sort and map.compute. Overflow raises on
        every rank together."""
        t = time.perf_counter()
        with self._device_lock:
            sk, si, vcounts, ovf = streaming_sort(
                u32.from_numpy(keys, self.device),
                u32.from_numpy(ids, self.device),
                num_workers=self.w, num_rounds=self.plan.num_rounds,
                cfg=self.cfg, device=self.device, mesh=self.mesh)
            if ovf:
                raise RuntimeError(
                    "shuffle block overflow — raise capacity_factor"
                )
            vcounts = vcounts.cpu().numpy()
            rows = None
            if self.mesh is not None and self.pw:
                rows = self._fetch_rows(si, vcounts, ids, payload)
            sk, si = u32.to_numpy(sk), u32.to_numpy(si)
        if timeline is not None:
            timeline.add("map.device_sort", t, worker=tag)
            timeline.add("map.compute", t, worker=tag)
        return sk, si, vcounts, rows

    def _fetch_rows(self, si, vcounts, ids, payload):
        """The payload rows of each of the rank's workers' sorted records
        (si, (W/G * m,) u32 on the card; vcounts valid each), by
        late_fetch_payload over the wave's record positions: position //
        (n_wave/W) is the worker whose rank loaded the row. A position is
        id - base when the whole wave's ids are contiguous (gensort's
        layout: each rank's share is, from the first rank's base on);
        otherwise every rank gathers the wave's ids and finds positions
        as the one-process encode stage does."""
        mesh, dev = self.mesh, self.device
        wl = self.wl
        m = si.shape[0] // wl
        nr = ids.shape[0]  # this rank's records of the wave
        base = _contiguous_id_base(ids)
        every = mesh.all_gather_object(base)
        contiguous = None not in every and every == [
            every[0] + r * nr for r in range(mesh.world)]
        valid = (torch.arange(m, device=dev)[None, :]
                 < torch.from_numpy(vcounts).to(dev)[:, None])
        if contiguous:
            pos = u32.widen(si).reshape(wl, m) - every[0]
        else:
            wave = np.concatenate(mesh.all_gather_object(
                np.asarray(ids, np.uint32)))
            order = np.argsort(wave)
            at = np.minimum(np.searchsorted(wave[order], u32.to_numpy(si)),
                            wave.size - 1)
            pos = torch.from_numpy(order[at]).to(dev).reshape(wl, m)
        pos = torch.where(valid, pos, u32.MASK)
        n = nr // wl  # the wave's records per worker
        rows, overflow = late_fetch_payload(
            u32.narrow(pos), u32.from_numpy(payload, dev).reshape(wl, n, -1),
            num_workers=self.w, records_per_worker=n,
            capacity=self.cfg.block_capacity(m), impl=self.cfg.impl,
            mesh=mesh)
        if any_across(overflow, mesh):
            raise RuntimeError("payload fetch block overflow — raise "
                               "capacity_factor")
        return [u32.to_numpy(rows[i, :c]) for i, c in enumerate(vcounts)]

    def encode_and_spill(self, store: StoreBackend, bucket: str, g: int,
                         sk, si, vcounts, ids, payload, *,
                         spiller: staging.AsyncWriter,
                         timeline: PhaseTimeline, tag: str,
                         offsets_out: dict, span: str = "map.encode",
                         t0: float | None = None, rows=None) -> None:
        """Stage 2 of the map body: slice each held worker's run out of
        the sorted wave, gather payload rows (from the wave's `ids` and
        `payload`, or the fetched `rows` with a mesh), encode, and spill;
        per-reducer offsets go to `offsets_out[(g, wid)]` and the spill
        metadata, under global worker ids."""
        plan, pw = self.plan, self.pw
        t_comp = time.perf_counter() if t0 is None else t0
        id_base = _contiguous_id_base(ids) if pw and rows is None else None
        order = sorted_ids = None
        if pw and rows is None and id_base is None:
            order = np.argsort(ids)
            sorted_ids = ids[order]
        seg = sk.shape[0] // self.wl
        for i, wid in enumerate(self.worker_ids):
            n = int(vcounts[i])
            run_k = sk[i * seg : i * seg + n]
            run_i = si[i * seg : i * seg + n]
            run_p = None
            if rows is not None:
                run_p = rows[i]
            elif pw:
                if id_base is not None:
                    sel = run_i.astype(np.int64) - id_base
                else:
                    sel = order[np.searchsorted(sorted_ids, run_i)]
                run_p = payload[sel]
            if self._local_bounds is not None:
                internal = np.searchsorted(
                    run_k, self._local_bounds[wid], side="left")
            else:
                internal = np.empty((0,), np.int64)
            offsets = np.concatenate(([0], internal, [n])).astype(np.int64)
            offsets_out[(g, wid)] = offsets
            data = rec.encode_records(run_k, run_i, run_p)
            # Submit each encoded run immediately: the AsyncWriter
            # backpressure bound only holds if we never batch them.
            timeline.add(span, t_comp, worker=tag)
            t_spill = time.perf_counter()
            spiller.submit(_timed_spill, timeline, tag, store, bucket,
                           _spill_key(plan, g, wid), data, {
                               "records": n,
                               "wave": g,
                               "worker": wid,
                               "reducer_offsets": [int(o) for o in offsets],
                           })
            timeline.add("map.spill_wait", t_spill, worker=tag)
            t_comp = time.perf_counter()
        timeline.add(span, t_comp, worker=tag)

    def compute_and_spill(self, store: StoreBackend, bucket: str, g: int,
                          keys, ids, payload, *, spiller: staging.AsyncWriter,
                          timeline: PhaseTimeline, tag: str,
                          offsets_out: dict) -> None:
        """Sort wave g and spill each held worker's run — the monolithic
        (non-pipelined) map body."""
        t_comp = time.perf_counter()
        sk, si, vcounts, rows = self.device_sort(keys, ids, payload)
        self.encode_and_spill(store, bucket, g, sk, si, vcounts, ids,
                              payload, spiller=spiller, timeline=timeline,
                              tag=tag, offsets_out=offsets_out,
                              span="map.compute", t0=t_comp, rows=rows)


def _load_records(store: StoreBackend, bucket: str, meta, a: int, b: int,
                  count: int, rows: np.ndarray, at: int,
                  chunk_bytes: int) -> int:
    """Records [a, b) of one encoded object of `count` records, by ranged
    GETs of at most `chunk_bytes`, into rows[at:]. The range starts at
    byte 0 when a == 0, so the object's header is read (and checked) by
    the reader of its first record. Returns b - a."""
    rb = rows.shape[1] * 4
    lo, length = rec.body_range(a, b - a, rows.shape[1] - 2)
    if a == 0:
        lo, length = 0, length + rec.HEADER_BYTES
    dest = memoryview(rows).cast("B")
    off = at * rb
    header = b""
    for start in range(lo, lo + length, chunk_bytes):
        chunk = store.get_range(bucket, meta.key, start,
                                min(chunk_bytes, lo + length - start))
        view = memoryview(chunk)
        if start < rec.HEADER_BYTES:
            take = rec.HEADER_BYTES - start
            header += bytes(view[:take])
            view = view[take:]
        dest[off:off + len(view)] = view
        off += len(view)
    if a == 0:
        n, pw = rec.decode_header(header)
        if (n, pw) != (count, rows.shape[1] - 2):
            raise ValueError(f"{meta.key}: header says {n} records of "
                             f"{pw} payload words, the listing "
                             f"{count} of {rows.shape[1] - 2}")
    if off != (at + b - a) * rb:
        raise ValueError(f"{meta.key}: ranged read of records [{a}, {b}) "
                         f"returned {off - at * rb} bytes")
    return b - a
