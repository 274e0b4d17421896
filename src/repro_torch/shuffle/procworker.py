"""ProcessWorker: a cluster worker backed by a real subprocess.

Port of src/repro/shuffle/procworker.py. ThreadWorkers emulate the fleet
inside one process: one GIL and one shared WaveSorter whose device lock
serializes every wave sort, so thread fleets show request-level
parallelism but no COMPUTE parallelism. A ProcessWorker spawns
`repro_torch.shuffle.worker_main` with its own interpreter and its own
torch runtime, talking line-JSON over stdin/stdout — so a W=4 process
fleet sorts four waves concurrently. On a card each child opens its own
CUDA context (and loads the kernels at its warm sort, before it reports
ready); the children share the card. The child is started with
`subprocess.Popen`, which execs a fresh interpreter: nothing forks a
process that has CUDA initialized.

The parent half implements the same `Worker` protocol the drivers
already speak — `run_map_phase` / `run_reduce_phase` drain the driver's
pop/confirm callbacks — plus the elastic extensions:

  * `last_beat()` — monotonic timestamp of the last protocol message
    (every message counts; the child also heartbeats on an interval),
    feeding the ElasticPhaseDriver's miss detector;
  * `fence()` — SIGKILL. After the driver declares this worker dead, no
    in-flight laggard in the child can ever reach a durable commit.

Threading layout (the part that must not deadlock): one reader thread
owns stdout and handles quick events inline — heartbeats, `done`
confirmations, `commit` gate checks, `requeue` routing (all lock-bound
pool operations) — while `need` tokens are handed to a dedicated pop
server thread, because `pop_next()` may legitimately block for seconds
waiting for releasable work. A blocked pop therefore never stops the
reader from serving the commit gate of a finisher that is about to win
a speculative race.

The store config travels as a JSON spec (`store_spec_for` builds one
from a live filesystem-backed store), optionally carrying a per-worker
FaultProfile — the chaos harness uses that to make one PROCESS a
straggler while the shared data stays untouched.
"""
from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time

from repro_torch.io.backends import StoreStats
from repro_torch.shuffle.executor import Worker, WorkerContext, WorkerFailure


def store_spec_for(store, *, fault: dict | None = None,
                   chunk_size: int | None = None) -> dict:
    """Serialize a filesystem-backed store (ObjectStore / bare
    FilesystemBackend / TieredStore over two of them, possibly
    middleware-wrapped — anything exposing `.root`, or `.durable`/`.ssd`
    that do) into the spec a child process rebuilds its own handle from.
    `fault` is an optional io/middleware.FaultProfile field dict applied
    in the CHILD only (per-worker straggler injection)."""
    durable = getattr(store, "durable", None)
    ssd = getattr(store, "ssd", None)
    if durable is not None and ssd is not None:
        spec = {"kind": "tiered", "durable_root": durable.root,
                "ssd_root": ssd.root,
                "ssd_prefixes": list(getattr(store, "ssd_prefixes",
                                             ("spill/",)))}
    else:
        root = getattr(store, "root", None)
        if root is None:
            raise ValueError(
                f"{type(store).__name__} has no filesystem root; process "
                "workers need a store both sides can open (MemoryBackend "
                "cannot cross a process boundary)")
        spec = {"kind": "fs", "root": root}
    spec["chunk_size"] = int(chunk_size if chunk_size is not None
                             else getattr(store, "chunk_size", 4 << 20))
    if fault:
        spec["fault"] = dict(fault)
    return spec


class _RemoteStats:
    """Parent-side stand-in for the worker's store view: the child ships
    a stats snapshot at every phase end; the driver's
    `per_worker_stats()` reads the latest one here."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latest = StoreStats()

    def update(self, fields: dict) -> None:
        with self._lock:
            self._latest = StoreStats(**fields)

    def stats_snapshot(self) -> StoreStats:
        with self._lock:
            return self._latest


class ProcessWorker(Worker):
    """Subprocess-backed Worker (see module docstring).

    `die_after_tasks` injects a pre-commit-deterministic process death
    at the N+1-th task pop (chaos harness). `fault` is a FaultProfile
    dict applied to the child's store view (straggler injection).
    `num_workers` is the sort's W (the batch axis), `device` where the
    child sorts and merges. `launches` holds the child's kernel launch
    counts (since it was ready) as of its last phase end, `shapes` the
    shapes its kernels were launched at; a killed child's launches after
    its last phase end are lost.
    """

    def __init__(self, name: str, *, store, bucket: str, plan,
                 num_workers: int = 8, device="cuda",
                 heartbeat_interval_s: float = 0.2,
                 die_after_tasks: int | None = None,
                 fault: dict | None = None,
                 ready_timeout_s: float = 180.0):
        import dataclasses

        import repro_torch

        self.name = name
        self.store = _RemoteStats()
        self._beat: float | None = None
        self._dead = False
        self._wlock = threading.Lock()
        self._need: queue.Queue = queue.Queue()
        self._phase_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._state: dict | None = None
        self._ready = threading.Event()
        self.launches: dict[str, int] = {}
        self.shapes: dict[str, set] = {}

        spec = {
            "name": name,
            "store": store_spec_for(store, fault=fault),
            "bucket": bucket,
            "plan": dataclasses.asdict(plan),
            "num_workers": int(num_workers),
            "device": str(device),
            "heartbeat_interval_s": float(heartbeat_interval_s),
        }
        if die_after_tasks is not None:
            spec["die_after_tasks"] = int(die_after_tasks)

        # repro_torch is a namespace package (__file__ is None): derive
        # the import root from its search path instead.
        src_dir = os.path.dirname(
            os.path.abspath(list(repro_torch.__path__)[0]))
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        self._proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "repro_torch.shuffle.worker_main"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=None,
            text=True, bufsize=1, env=env)
        self._send(spec)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"procworker-{name}-reader")
        self._reader.start()
        # The reader also sets `_ready` when the child exits, so a child
        # that fails to start (no card for device="cuda") raises at once.
        if not self._ready.wait(ready_timeout_s) or self._dead:
            why = (f"child exited before ready (rc={self._proc.wait()})"
                   if self._dead else
                   f"child not ready after {ready_timeout_s}s")
            self.fence()
            raise WorkerFailure(f"{name}: {why}")

    # -- plumbing ---------------------------------------------------------

    def _send(self, msg: dict) -> None:
        try:
            with self._wlock:
                self._proc.stdin.write(json.dumps(msg) + "\n")
                self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            # Child gone; the reader's EOF handling owns the fallout.
            pass

    def _read_loop(self) -> None:
        try:
            for line in self._proc.stdout:
                self._beat = time.monotonic()
                if not line.strip():
                    continue
                self._handle(json.loads(line))
        finally:
            self._dead = True
            self._ready.set()
            self._finish_phase(WorkerFailure(
                f"{self.name}: worker process exited "
                f"(rc={self._proc.poll()})"))

    def _handle(self, msg: dict) -> None:
        ev = msg.get("ev")
        if ev == "ready":
            self._ready.set()
        elif ev == "hb":
            pass  # the timestamp update above is the whole point
        elif ev == "need":
            self._need.put(True)
        elif ev == "done":
            with self._state_lock:
                st = self._state
            if st is not None:
                st["on_done"](msg["task"])
        elif ev == "commit":
            with self._state_lock:
                st = self._state
            gate = st.get("commit_gate") if st else None
            ok = True if gate is None else bool(gate(self.name, msg["task"]))
            self._send({"cmd": "commit", "task": msg["task"], "ok": ok})
        elif ev == "requeue":
            with self._state_lock:
                st = self._state
            on_rq = st.get("on_requeue") if st else None
            from repro_torch.io.backends import ObjectNotFound
            exc = ObjectNotFound(msg.get("error", "input lost"))
            handled = (bool(on_rq(self.name, msg["task"], exc))
                       if on_rq is not None else False)
            self._send({"cmd": "requeue_ack", "task": msg["task"],
                        "ok": handled})
        elif ev == "phase_end":
            self.store.update(msg.get("stats", {}))
            self.launches = dict(msg.get("launches", {}))
            self.shapes = {k: {tuple(s) for s in v}
                           for k, v in msg.get("shapes", {}).items()}
            self._finish_phase(None)
        elif ev == "error":
            self._finish_phase(RuntimeError(
                f"{self.name}: worker process phase failed:\n"
                f"{msg.get('detail', '')}"))

    def _finish_phase(self, error: BaseException | None) -> None:
        with self._state_lock:
            st = self._state
            if st is None:
                return
            if error is not None and st["error"] is None:
                st["error"] = error
            self._state = None
        self._need.put(None)  # unblock the pop server
        st["event"].set()

    def _pop_server(self, st: dict, pop_next) -> None:
        while True:
            token = self._need.get()
            if token is None:
                return
            try:
                task = pop_next()
            except BaseException as e:
                self._finish_phase(e)
                return
            self._send({"cmd": "task", "task": task})

    def _run_phase(self, phase: str, ctx: WorkerContext, pop_next,
                   on_done) -> None:
        with self._phase_lock:
            if self._dead:
                raise WorkerFailure(f"{self.name}: worker process is dead")
            st = {
                "event": threading.Event(), "error": None,
                "on_done": on_done,
                # Map attempts gate on the speculation claim pool too
                # (the child polls the commit RPC per fetched chunk);
                # the reduce gate additionally covers requeue routing.
                "commit_gate": (ctx.commit_gate if phase == "reduce"
                                else ctx.map_commit_gate),
                "on_requeue": ctx.on_requeue if phase == "reduce" else None,
            }
            with self._state_lock:
                self._state = st
            server = threading.Thread(
                target=self._pop_server, args=(st, pop_next), daemon=True,
                name=f"procworker-{self.name}-pop")
            server.start()
            self._send({"cmd": "phase", "phase": phase,
                        "gated": phase == "map"
                        and ctx.map_commit_gate is not None})
            st["event"].wait()
            self._need.put(None)
            server.join()
            # Drain stale sentinels so the next phase starts clean.
            while True:
                try:
                    self._need.get_nowait()
                except queue.Empty:
                    break
            if st["error"] is not None:
                raise st["error"]

    # -- Worker protocol --------------------------------------------------

    def run_map_phase(self, ctx, pop_next, on_done):
        self._run_phase("map", ctx, pop_next, on_done)

    def run_reduce_phase(self, ctx, pop_next, on_done):
        self._run_phase("reduce", ctx, pop_next, on_done)

    def last_beat(self) -> float | None:
        return self._beat

    def fence(self) -> None:
        """SIGKILL: after the driver declares this worker dead, nothing
        in the child may reach a durable commit."""
        self._dead = True
        try:
            self._proc.kill()
        except OSError:
            pass

    def close(self) -> None:
        """Graceful shutdown (idempotent); escalates to SIGKILL."""
        if self._proc.poll() is None and not self._dead:
            self._send({"cmd": "shutdown"})
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
        elif self._proc.poll() is None:
            self._proc.kill()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
        self._reader.join(timeout=5)
        with self._wlock:
            try:
                self._proc.stdin.close()
            except OSError:
                pass


__all__ = ["ProcessWorker", "store_spec_for"]
