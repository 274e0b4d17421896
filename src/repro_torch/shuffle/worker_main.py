"""Subprocess worker entry point: `python -m repro_torch.shuffle.worker_main`.

Port of src/repro/shuffle/worker_main.py: the child half of
shuffle/procworker.ProcessWorker. The parent writes one JSON spec line
to stdin; the child rebuilds its world from it — a store handle over the
SHARED filesystem root (its own middleware stack: metrics, plus an
optional latency/bandwidth fault profile to make this one worker a
straggler), its own torch runtime on `spec["device"]` (on a card: its
own CUDA context, which loads the kernels at the warm sort), and the
sort plan with its W batched workers — then speaks a line-delimited
JSON protocol:

  child -> parent                      parent -> child
  {"ev":"ready"}                       {"cmd":"phase","phase":"map"}
  {"ev":"hb"}                          {"cmd":"task","task":3|null}
  {"ev":"need"}                        {"cmd":"commit","task":7,"ok":true}
  {"ev":"done","task":3}               {"cmd":"requeue_ack","task":7,
  {"ev":"commit","task":7}                                  "ok":true}
  {"ev":"requeue","task":7}            {"cmd":"shutdown"}
  {"ev":"phase_end","phase":...,
   "stats":{...},"launches":{...},
   "shapes":{...}}
  {"ev":"error","detail":"..."}

Pop ("need"/"task") and commit ("commit") round trips are serialized by
SEPARATE child-side locks: a pop may block parent-side for seconds (the
elastic ClaimPool waits for work), and a finisher's commit gate must
never queue behind it — that ordering freedom is what makes the
loser-abort path deadlock-free. "done" is fire-and-forget and is sent
only after the durable multipart commit (the same confirmation contract
every Worker obeys). "phase_end" also carries the child's kernel launch
counts since it declared itself ready, and the shapes its kernels were
launched at.

Durability recovery hinges on state the STORE holds, not the process:
reduce-side run offsets are reloaded from spill-object metadata
(`reducer_offsets`, written by the map side) at every reduce phase
start, so this child can merge runs that a different — possibly dead —
worker spilled. A missing offset or vanished run surfaces as
ObjectNotFound and is routed to the parent as a requeue, not a crash.

Fault injection: `die_after_tasks` N makes the child `os._exit(3)` at
its N+1-th task pop — before any claim, never between a commit and its
confirmation — so injected process deaths are pre-commit-deterministic
exactly like executor.FaultyWorker's task budget.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import sys
import threading
import time
import traceback


def _build_store(spec: dict):
    from repro_torch.io.backends import FilesystemBackend
    from repro_torch.io.middleware import (FaultProfile, LatencyBandwidthMiddleware,
                                     MetricsMiddleware)
    from repro_torch.io.tiered import TieredStore

    chunk = int(spec.get("chunk_size", 4 << 20))

    def fs(root):
        return FilesystemBackend(root, chunk_size=chunk)

    if spec["kind"] == "tiered":
        store = TieredStore(fs(spec["durable_root"]), fs(spec["ssd_root"]),
                            ssd_prefixes=tuple(spec.get("ssd_prefixes",
                                                        ("spill/",))))
    else:
        store = fs(spec["root"])
    fault = spec.get("fault")
    if fault:
        # Per-worker injected slowness: this is how a chaos schedule
        # makes ONE process a straggler without touching the shared data.
        store = LatencyBandwidthMiddleware(store, FaultProfile(**fault))
    return MetricsMiddleware(store)


def kernel_wrappers():
    """The four kernel wrappers of this process."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
    from repro_torch.kernels.kway_merge import merge_sorted_pairs_indexed
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    return (bitonic_sort_blocks, partition_offsets_blocks,
            merge_sorted_pairs, merge_sorted_pairs_indexed)


def kernel_launches() -> dict[str, int]:
    """This process's launch count of each kernel wrapper, by name."""
    return {f.__name__: f.launches for f in kernel_wrappers()}


def kernel_shapes() -> dict[str, list]:
    """The shapes each kernel wrapper of this process launched at."""
    return {f.__name__: sorted(f.shapes) for f in kernel_wrappers()}


class _Protocol:
    """Line-JSON duplex with routed replies (see module docstring)."""

    def __init__(self, out):
        self._out = out
        self._wlock = threading.Lock()
        self.cmds: queue.Queue = queue.Queue()  # phase / shutdown
        self.tasks: queue.Queue = queue.Queue()  # "task" replies
        self.commits: queue.Queue = queue.Queue()  # "commit" replies
        self.requeues: queue.Queue = queue.Queue()  # "requeue_ack" replies
        self.pop_lock = threading.Lock()
        self.commit_lock = threading.Lock()
        self.requeue_lock = threading.Lock()

    def send(self, msg: dict) -> None:
        data = json.dumps(msg)
        with self._wlock:
            self._out.write(data + "\n")
            self._out.flush()

    def reader(self) -> None:
        routes = {"task": self.tasks, "commit": self.commits,
                  "requeue_ack": self.requeues}
        for line in sys.stdin:
            if not line.strip():
                continue
            msg = json.loads(line)
            routes.get(msg.get("cmd"), self.cmds).put(msg)
        # Parent gone: a worker with no driver has no reason to live.
        self.cmds.put({"cmd": "shutdown"})
        for q in routes.values():
            q.put(None)


def main() -> int:
    proto = _Protocol(sys.stdout)
    # Stray prints (library chatter) must not corrupt the protocol pipe.
    sys.stdout = sys.stderr
    spec = json.loads(sys.stdin.readline())
    name = spec["name"]

    import numpy as np

    from repro_torch.core.external_sort import ExternalSortPlan
    from repro_torch.io.backends import ObjectNotFound
    from repro_torch.shuffle import runtime as rt
    from repro_torch.shuffle.sort import DeviceMergeReduceOp, MergeReduceOp, SortMapOp

    store = _build_store(spec["store"])
    bucket = spec["bucket"]
    plan = ExternalSortPlan(**spec["plan"])
    map_op = SortMapOp(plan, int(spec["num_workers"]),
                       device=spec["device"])
    num_tasks = map_op.plan_tasks(store, bucket)
    num_partitions = map_op.sorter.w * map_op.sorter.r1
    if getattr(plan, "reduce_merge_impl", "numpy") == "device":
        reduce_op = DeviceMergeReduceOp(plan, map_op)
    else:
        reduce_op = MergeReduceOp(plan, map_op)

    def refresh_offsets() -> None:
        """Rebuild run offsets from spill metadata in the shared store —
        the process-worker substitute for the in-process offsets dict a
        thread fleet shares. Runs another worker spilled (or re-spilled
        after a loss) become mergeable here."""
        for meta in store.list_objects(bucket, plan.spill_prefix):
            md = meta.metadata
            if {"wave", "worker", "reducer_offsets"} <= md.keys():
                map_op.spill_offsets[(int(md["wave"]), int(md["worker"]))] = (
                    np.asarray(md["reducer_offsets"], np.int64))

    class _StoreBackedSources:
        """reduce_op proxy: a KeyError from the offsets dict means this
        child never saw that wave's spill — refresh from the store, and
        if the run truly is gone (correlated spill loss), surface it as
        ObjectNotFound so the scheduler requeues instead of crashing."""

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

    # Warm the sort BEFORE declaring ready: the first device_sort opens
    # this process's CUDA context and loads the kernels, and W children
    # doing that inside the measured region would charge the process
    # fleet W start-ups where the thread fleet pays one. Uniform random
    # keys (the gensort distribution) keep every partition under
    # capacity so the overflow check stays quiet — evenly STRIDED keys
    # would pin the round-routing bits and overflow one block.
    n_warm = int(plan.records_per_wave)
    warm_keys = np.random.default_rng(0).integers(
        0, 1 << 32, n_warm, dtype=np.uint64).astype("<u4")
    map_op.sorter.device_sort(warm_keys, np.zeros(n_warm, "<u4"))
    launch_base = kernel_launches()

    die_after = spec.get("die_after_tasks")
    popped = 0

    def rpc_pop():
        nonlocal popped
        with proto.pop_lock:
            if die_after is not None and popped >= die_after:
                # Injected process death: at pop time, pre-commit, like
                # FaultyWorker's task budget — the local spill tier dies
                # with the process.
                os._exit(3)
            proto.send({"ev": "need"})
            msg = proto.tasks.get()
            if msg is None:
                return None
            task = msg["task"]
            if task is not None:
                popped += 1
            return task

    def rpc_done(task: int) -> None:
        proto.send({"ev": "done", "task": int(task)})

    def rpc_commit(r: int) -> bool:
        with proto.commit_lock:
            proto.send({"ev": "commit", "task": int(r)})
            msg = proto.commits.get()
        if msg is None:
            return False  # parent gone: never commit into the void
        assert msg["task"] == r, (msg, r)
        return bool(msg["ok"])

    def rpc_requeue(r: int, exc: BaseException) -> bool:
        with proto.requeue_lock:
            proto.send({"ev": "requeue", "task": int(r),
                        "error": type(exc).__name__})
            msg = proto.requeues.get()
        return bool(msg and msg["ok"])

    def heartbeat(stop: threading.Event) -> None:
        interval = float(spec.get("heartbeat_interval_s", 0.2))
        while not stop.wait(interval):
            proto.send({"ev": "hb"})

    def run_phase(phase: str, gated: bool) -> None:
        control = rt.JobControl()
        timeline = rt.PhaseTimeline(origin=time.perf_counter())
        if phase == "map":
            # `gated` means the parent runs a speculation claim pool for
            # this phase: poll the commit RPC per fetched map chunk (and
            # at commit) so a beaten attempt aborts at its next chunk
            # instead of loading the whole wave — the process-fleet
            # mirror of the reduce side's _AbandonGatedReads.
            rt.run_map_tasks(store, bucket, map_op, rpc_pop, plan=plan,
                             timeline=timeline, control=control,
                             tag_prefix=f"{name}/", on_done=rpc_done,
                             commit_gate=rpc_commit if gated else None)
        else:
            refresh_offsets()
            slots = min(plan.parallel_reducers, num_partitions)
            governor = rt.AdaptiveBudgetGovernor(
                budget=plan.reduce_memory_budget_bytes,
                chunk_cap=plan.merge_chunk_bytes,
                record_bytes=plan.record_bytes,
                slots=slots, partitions=num_partitions)
            shared = rt.ReduceShared(
                plan=plan, bucket=bucket, reduce_op=_StoreBackedSources(),
                governor=governor, timeline=timeline,
                peak=rt.PeakTracker(), control=control)
            rt.ReduceScheduler(
                store, shared, width=slots, runs_hint=num_tasks,
                tag_prefix=f"{name}/", requeue=(ObjectNotFound,),
                on_requeue=rpc_requeue, commit_gate=rpc_commit,
            ).run(rpc_pop, on_done=rpc_done)
        control.raise_first()

    reader = threading.Thread(target=proto.reader, daemon=True,
                              name="proto-reader")
    reader.start()
    hb_stop = threading.Event()
    hb = threading.Thread(target=heartbeat, args=(hb_stop,), daemon=True,
                          name="heartbeat")
    hb.start()
    proto.send({"ev": "ready", "tasks": num_tasks,
                "partitions": num_partitions})
    try:
        while True:
            cmd = proto.cmds.get()
            if cmd["cmd"] == "shutdown":
                return 0
            phase = cmd["phase"]
            try:
                run_phase(phase, bool(cmd.get("gated", False)))
            except BaseException:
                proto.send({"ev": "error", "phase": phase,
                            "detail": traceback.format_exc(limit=20)})
            else:
                now = kernel_launches()
                proto.send({"ev": "phase_end", "phase": phase,
                            "stats": dataclasses.asdict(
                                store.stats_snapshot()),
                            "launches": {k: now[k] - launch_base[k]
                                         for k in now},
                            "shapes": kernel_shapes()})
    finally:
        hb_stop.set()


if __name__ == "__main__":
    sys.exit(main())
