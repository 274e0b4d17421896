"""Run one cell over G ranks, one process a card: the harness's side of a
cell whose `chips` is more than 1.

Rank 0 is the process that runs run.py; ranks 1..G-1 are started with
the spawn method. Rank r binds card r (the CPU where `device` is "cpu",
as in the tests) and joins one group through the port's own
`launch/mesh.init_rank_mesh`: NCCL on cards, gloo on the CPU, a
FileStore in a temporary directory, and a collective timeout (the
traffic's `collective_timeout_s`, else TIMEOUT_S), so that a rank that
hangs in a collective raises in the others and the run ends non-zero.

The cell's driver gives `body(cell, mesh, *, seed, device, wrap) ->
Rank`: the rank's records made from the seed, the call of the program
on them over `mesh` (the `RankMesh` its users pass), and the check of
one call's output. The runner runs one protocol on every rank:

  set-up    body(...), `warmup_calls` calls, then a barrier; `setup_s` is
            rank 0's time from its process start to the barrier's end;
  window    calls back to back; after each, rank 0 reads its clock, and
            its decision to stop reaches every rank in one 4-byte
            broadcast outside any program span, so every rank makes the
            same calls; the kept call is drawn from the seed alike on
            every rank; the rate is calls x the records of all ranks over
            rank 0's window;
  trace     with `trace`, every rank profiles `trace_calls` more calls
            (the collectives need every rank); the per-layer readers and
            the breakdown read rank 0's readings and trace, so a
            per-rank quantity (`records_per_call`) is the rank's own;
            the device's busy_s and window_s are the ranks' means, and
            each rank's busy share goes to the notes;
  checks    each rank checks its own workers' output of the kept call;
            each check is added over the ranks by name, its limit as the
            driver gives it; `attempted` and `failed` count calls of the
            whole mesh;
  memory    each card's peak, in rank order; the result's
            `memory_peak_bytes` is the fullest card's.

A rank that raises, or whose process ends before it reports, stops the
others: its traceback goes to stderr at once and `run` raises
RankFailed. Each spawned rank looks at its end for modules of the JAX
package (lib/guard.py) and reports what it found; rank 0's look is
run.py's.
"""
from __future__ import annotations

import dataclasses
import os
import random
import sys
import tempfile
import threading
import time
import traceback
import types
from typing import Callable

from perfbench.lib import guard
from perfbench.lib.outcome import Check, Outcome

#: Seconds a collective may wait for the other ranks before it raises.
TIMEOUT_S = 120.0
#: Seconds rank 0 waits for ranks 1..G-1 to start (a fresh interpreter
#: that imports torch) before the group's rendezvous.
START_S = 300.0
#: Seconds rank 0 waits, once it has failed, for the others' reports.
SETTLE_S = 5.0


@dataclasses.dataclass
class Rank:
    """What a driver's body hands the runner on one rank."""

    call: Callable[[], object]  # one call of the program, synchronised
    check: Callable[[object], list]  # [Check] of one call's output
    records: int  # this rank's records a call
    metric: str  # the end-to-end rate's name: records/s of all ranks
    readings: dict = dataclasses.field(default_factory=dict)  # for readers
    before_trace: Callable[[], None] | None = None


@dataclasses.dataclass
class Report:
    """What one rank hands back to rank 0 (pickled from ranks 1..G-1)."""

    rank: int
    calls: int
    kept_call: int
    records: int
    checks: list
    memory_peak_bytes: int
    reserved_peak_bytes: int
    setup_s: float
    window_s: float
    busy_s: float | None = None  # traced runs: device busy seconds
    trace_window_s: float | None = None
    forbidden: list = dataclasses.field(default_factory=list)


class RankFailed(RuntimeError):
    """A rank raised, or ended or hung before it reported."""


def run(cell, body, *, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", wrap=None) -> Outcome:
    """Run `cell` over cell.chips ranks with the driver's `body`; `wrap`
    (picklable: it reaches every rank) is handed to the body."""
    world = int(cell.chips)
    timeout_s = float(cell.traffic.get("collective_timeout_s", TIMEOUT_S))
    args = (cell, body, seed, seconds, trace, device, wrap, timeout_s)
    with tempfile.TemporaryDirectory(prefix="perfbench-ranks-") as tmp:
        store = os.path.join(tmp, "rendezvous")
        peers = _Peers(world, store, args)
        try:
            mine, extra = _rank(0, world, store, *args, t0=t0,
                                ready=peers.wait_started)
        except BaseException:
            failed = time.time()
            tb = traceback.format_exc()
            peers.settle(SETTLE_S)
            quiet = peers.running()
            peers.stop()
            raise RankFailed(_failures(peers.errors + [(0, failed, tb)]) + (
                f"still running when stopped: ranks {quiet}\n"
                if quiet else ""))
        try:
            theirs = peers.reports(timeout_s + 60.0)
        finally:
            peers.stop(grace_s=10.0)
    return combine([mine] + theirs, extra)


def combine(reports: list[Report], extra) -> Outcome:
    """The run's Outcome from every rank's report (rank order) and what
    rank 0 keeps in its process (`extra`: the rate's name, the readings,
    the trace, notes)."""
    calls = [r.calls for r in reports]
    if len(set(calls)) != 1 or len({r.kept_call for r in reports}) != 1:
        raise RankFailed(f"the ranks made different calls: calls {calls}, "
                         f"kept {[r.kept_call for r in reports]}")
    names = [c.name for c in reports[0].checks]
    for r in reports:
        if [c.name for c in r.checks] != names:
            raise RankFailed(f"rank {r.rank} checks "
                             f"{[c.name for c in r.checks]}, rank 0 {names}")
    checks = [Check(c.name, sum(r.checks[i].value for r in reports), c.limit)
              for i, c in enumerate(reports[0].checks)]
    head = reports[0]
    records = sum(r.records for r in reports)
    peaks = [r.memory_peak_bytes for r in reports]
    device = {"count": len(reports), "memory_peak_bytes_by_card": peaks}
    notes = {"ranks": len(reports), "calls": head.calls,
             "kept_call": head.kept_call, "records": records,
             "records_by_rank": [r.records for r in reports],
             "calls_by_rank": calls, "window_s": head.window_s,
             "setup_s": head.setup_s,
             "setup_s_by_rank": [r.setup_s for r in reports],
             "reserved_peak_bytes_by_card": [r.reserved_peak_bytes
                                             for r in reports],
             "checks_by_rank": [{c.name: c.value for c in r.checks}
                                for r in reports]}
    if head.busy_s is not None:
        device["busy_s"] = sum(r.busy_s for r in reports) / len(reports)
        device["window_s"] = sum(r.trace_window_s for r in reports) / len(
            reports)
        notes["busy_share_by_rank"] = [r.busy_s / r.trace_window_s
                                       for r in reports]
    notes.update(extra.notes)
    return Outcome(
        attempted=head.calls, failed=int(not all(c.ok for c in checks)),
        end_to_end={extra.metric: head.calls * records / head.window_s,
                    "setup_s": head.setup_s},
        readings=extra.readings, checks=checks, memory_peak_bytes=max(peaks),
        trace=extra.trace, host_spans=extra.host_spans, notes=notes,
        device=device,
        forbidden=[f"rank {r.rank}: {m}" for r in reports for m in
                   r.forbidden])


def _rank(rank, world, store, cell, body, seed, seconds, trace, device,
          wrap, timeout_s, *, t0, ready):
    """The protocol on one rank; returns (Report, rank 0's readings).
    `ready()` runs before the rendezvous: ranks 1..G-1 say they have
    started, rank 0 waits until they have, so that the group's timeout
    bounds waits for a rank's work and not for its interpreter's start."""
    import torch
    import torch.distributed as dist

    from perfbench.lib import devtrace, hooks
    from repro_torch.launch.mesh import init_rank_mesh

    ready()
    mesh = init_rank_mesh(int(cell.config["workers"]), device=device,
                          rank=rank, world=world, local_rank=rank,
                          store_path=store, timeout_s=timeout_s)
    try:
        me = body(cell, mesh, seed=seed, device=mesh.device, wrap=wrap)
        tr = cell.traffic
        kept = None
        for _ in range(int(tr["warmup_calls"])):
            kept = me.call()  # one output held through the next call
        mesh.barrier()
        setup_s = time.perf_counter() - t0

        nccl = mesh.backend == "nccl"
        stop = torch.zeros(1, dtype=torch.int32,
                           device=mesh.device if nccl else "cpu")
        rng = random.Random(seed)
        calls, kept_at = 0, -1
        start = time.perf_counter()
        while True:
            out = me.call()
            calls += 1
            if rng.random() * calls < 1.0:
                kept, kept_at = out, calls - 1
            out = None
            now = time.perf_counter()
            if rank == 0:
                stop.fill_(int(now - start >= seconds))
            dist.broadcast(stop, src=0, group=mesh.group)
            if stop.item():
                break
        window_s = now - start
        cuda = mesh.device.type == "cuda"
        peak = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
        reserved = torch.cuda.max_memory_reserved(mesh.device) if cuda else 0

        readings = types.SimpleNamespace(
            records_per_call=me.records, trace=None, launches=[],
            trace_calls=0, **me.readings)
        dtrace = None
        if trace:
            tc = int(tr["trace_calls"])

            def traced():
                for _ in range(tc):
                    with torch.profiler.record_function("perfbench.call"):
                        me.call()

            if me.before_trace is not None:
                me.before_trace()
            with hooks.launches() as log:
                _, dtrace = devtrace.capture(traced)
            readings.trace, readings.launches = dtrace, log
            readings.trace_calls = tc

        t_check = time.perf_counter()
        checks = me.check(kept)
        kept = None
        report = Report(
            rank=rank, calls=calls, kept_call=kept_at, records=me.records,
            checks=checks, memory_peak_bytes=int(peak),
            reserved_peak_bytes=int(reserved), setup_s=setup_s,
            window_s=window_s,
            busy_s=None if dtrace is None else dtrace.busy_s(),
            trace_window_s=None if dtrace is None else dtrace.window_s)
        extra = types.SimpleNamespace(
            metric=me.metric, readings=readings, trace=dtrace,
            host_spans=[] if dtrace is None else dtrace.ranges,
            notes={"check_s": time.perf_counter() - t_check})
    except BaseException:
        # an NCCL group with a collective in flight may hang on its way
        # out, and its process ends next; a gloo group leaves cleanly
        if mesh.backend == "gloo":
            mesh.close()
        raise
    mesh.close()
    return report, extra


def _child(rank, world, store, conn, *args) -> None:
    """Ranks 1..G-1: the protocol, then one report through `conn`; a
    failure reports its traceback and ends the process at once."""
    import torch

    t0 = time.perf_counter()
    parent = os.getppid()
    threading.Thread(target=_leave_with, args=(parent,), daemon=True).start()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    try:
        report, _ = _rank(rank, world, store, *args, t0=t0,
                          ready=lambda: conn.send(("started",)))
        report.forbidden = guard.loaded_forbidden()
        conn.send(("ok", report))
        conn.close()
    except BaseException:
        conn.send(("error", time.time(), traceback.format_exc()))
        conn.close()
        sys.stderr.flush()
        os._exit(1)


def _leave_with(parent: int) -> None:
    """End this rank when rank 0's process is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _failures(errors) -> str:
    """The failing ranks' tracebacks, the first to fail first."""
    parts = [f"rank {r} failed:\n{tb}" for r, _, tb in sorted(
        errors, key=lambda e: e[1])]
    return "\n".join(parts)


class _Peers:
    """Ranks 1..G-1, started with the spawn method, and a thread that
    reads the one report of each. A rank that fails has its traceback
    printed at once, and the other ranks are stopped."""

    def __init__(self, world: int, store: str, args: tuple):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.procs, self.conns = {}, {}
        self.got: dict[int, Report] = {}
        self.started: set[int] = set()
        self.errors: list[tuple[int, float, str]] = []
        self.stopping = False
        try:
            for rank in range(1, world):
                recv, send = ctx.Pipe(duplex=False)
                self.conns[rank] = recv
                p = ctx.Process(target=_child, name=f"perfbench-rank{rank}",
                                args=(rank, world, store, send) + args,
                                daemon=True)
                p.start()
                send.close()
                self.procs[rank] = p
        except BaseException:
            self.stop()
            raise
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        from multiprocessing.connection import wait

        pending = set(self.procs)
        while pending and not self.stopping:
            waits = {}
            for r in pending:
                waits[self.conns[r]] = r
                waits[self.procs[r].sentinel] = r
            for ready in wait(list(waits), timeout=1.0):
                r = waits[ready]
                if r in pending and self._take(r):
                    pending.discard(r)

    def _take(self, rank: int) -> bool:
        """Read what `rank` sent; True once it has reported or ended."""
        conn, p = self.conns[rank], self.procs[rank]
        msg = None
        try:
            while conn.poll():
                msg = conn.recv()
                if msg[0] != "started":
                    break
                self.started.add(rank)
                msg = None
        except EOFError:
            msg = None
        if msg is None and p.is_alive():
            return False
        if msg is not None and msg[0] == "ok":
            self.got[rank] = msg[1]
            return True
        if self.stopping:
            return True
        if msg is None:
            p.join(1.0)
            err = (rank, time.time(), f"its process ended (exit code "
                   f"{p.exitcode}) before it reported\n")
        else:
            err = (rank, msg[1], msg[2])
        self.errors.append(err)
        print(f"perfbench: rank {rank} failed:\n{err[2]}", file=sys.stderr,
              flush=True)
        self._kill()
        return True

    def wait_started(self) -> None:
        """Wait until every rank has started, or raise RankFailed."""
        deadline = time.monotonic() + START_S
        while len(self.started) < len(self.procs):
            if self.errors or self.stopping:
                raise RankFailed("a rank failed before the group formed")
            if time.monotonic() > deadline:
                raise RankFailed(f"ranks {self.running()} did not start "
                                 f"within {START_S:.0f} s")
            time.sleep(0.05)

    def running(self) -> list[int]:
        """The ranks that have neither reported nor failed (a hung rank
        among them)."""
        failed = {r for r, _, _ in self.errors}
        return sorted(set(self.procs) - set(self.got) - failed)

    def settle(self, seconds: float) -> None:
        """Wait up to `seconds` for the ranks still running to report."""
        self.thread.join(seconds)

    def reports(self, timeout_s: float) -> list[Report]:
        """Every rank's report in rank order, or RankFailed."""
        self.thread.join(timeout_s)
        missing = sorted(set(self.procs) - set(self.got))
        if self.errors or missing:
            errors = self.errors or [
                (r, time.time(), f"no report within {timeout_s:.0f} s\n")
                for r in missing]
            raise RankFailed(_failures(errors))
        return [self.got[r] for r in sorted(self.got)]

    def _kill(self) -> None:
        self.stopping = True
        for p in self.procs.values():
            if p.is_alive():
                p.kill()

    def stop(self, grace_s: float = 0.0) -> None:
        """Give the ranks `grace_s` to end, stop every rank still running
        and wait until each has ended."""
        deadline = time.monotonic() + grace_s
        for p in self.procs.values():
            p.join(max(0.0, deadline - time.monotonic()))
        self._kill()
        for p in self.procs.values():
            p.join(10.0)
        if hasattr(self, "thread"):
            self.thread.join(5.0)
        for c in self.conns.values():
            c.close()
