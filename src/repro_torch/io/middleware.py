"""Composable store middleware: the S3 behaviours the backend doesn't have.

The paper's numbers depend on S3 acting like S3: request latency and
per-connection bandwidth absorbed by pipelined I/O (§2.5), "503 Slow Down"
throttling absorbed by retries, and per-request fees computed from the
requests *actually issued* (§3.3.2). The filesystem backend emulates the
data plane only; each middleware here layers one behaviour over any
StoreBackend, so a realistic endpoint is a composition:

    RetryMiddleware(            # client-side: backoff + re-issue
      MetricsMiddleware(        # counts every attempt (retry-inflated)
        ThrottlingMiddleware(   # service-side: token-bucket 503s
          LatencyBandwidthMiddleware(   # wire: RTT + bytes/bandwidth
            FilesystemBackend(root)))))

Ordering matters and the stack above is the intended one: Metrics sits
*outside* the fault injectors so a throttled attempt is still an issued
(and billed) request, and *inside* Retry so every re-issue is counted —
which is exactly the retry-inflated request count the cost model's access
legs should price (core/cost_model.py). TracingMiddleware (the obs
layer's per-task request attribution) takes the same position, so its
per-attempt events and counters agree with the billed counts exactly.

Every middleware delegates the seven primitives through one `_call`
hook, and wraps multipart sessions so streamed part uploads flow through
the same hook (kind "put"). Derived StoreBackend methods (`put`,
`put_multipart`, `get_chunks`) are inherited, never delegated — they
decompose into primitives on the *outermost* layer, so each ranged chunk
and each part crosses the whole stack exactly once.

How the external-sort plan knobs (core/external_sort.ExternalSortPlan)
meet this stack — the request-shape invariants the middleware sees:

  merge_chunk_bytes / reduce_memory_budget_bytes — every reduce-side
      fetch is one ranged GET of at most merge_chunk_bytes (smaller when
      the global budget's governor apportions less), so the GET token
      bucket and latency injection see many small requests, exactly the
      traffic the paper's 503 regime throttles. The budget bounds
      decoded merge-buffer bytes, NOT request count: shrinking the chunk
      raises GET traffic (and the billed access leg) while lowering
      memory — the § 3.3.2 cost/memory trade made measurable.

  parallel_reducers (x cluster workers) — the number of merge loops
      issuing those GETs concurrently; with KillSwitchMiddleware (below)
      a worker's whole view dies at once, mid-request-stream.

  part_upload_fanout — concurrent put_part PUTs per partition crossing
      the stack out of order; each part is its own billed/throttled/
      retried attempt (_WrappedMultipart), like real S3 UploadPart
      traffic. PUT-bucket pressure scales with
      parallel_reducers x part_upload_fanout.
"""
from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

from repro_torch.io.backends import (MultipartUpload, ObjectMeta, RetryableError,
                               SlowDown, StoreBackend, StoreStats)
from repro_torch.obs.context import current_context
from repro_torch.obs.events import Tracer


class StoreMiddleware(StoreBackend):
    """Transparent wrapper: every primitive funnels through `_call`.

    `_call(kind, issue, read=..., nbytes=...)` is the single override
    point: `kind` is the request class ("get" | "put" | "head" | "list" |
    "delete" | "bucket"), `issue()` performs the inner call, `read=True`
    marks calls whose result length is the downloaded byte count, and
    `nbytes` carries the upload size for writes. Unknown attributes
    (e.g. `.root`, `.stats`) delegate to the wrapped store.
    """

    def __init__(self, inner: StoreBackend):
        self.inner = inner

    def __getattr__(self, name: str):
        return getattr(self.inner, name)

    def _call(self, kind: str, issue: Callable, *, read: bool = False,
              nbytes: int = 0):
        return issue()

    # -- primitives, funnelled --------------------------------------------

    def create_bucket(self, bucket: str) -> None:
        return self._call("bucket", lambda: self.inner.create_bucket(bucket))

    def get(self, bucket: str, key: str) -> bytes:
        return self._call("get", lambda: self.inner.get(bucket, key), read=True)

    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes:
        return self._call(
            "get", lambda: self.inner.get_range(bucket, key, start, length),
            read=True)

    def head(self, bucket: str, key: str) -> ObjectMeta:
        return self._call("head", lambda: self.inner.head(bucket, key))

    def list_objects(self, bucket: str, prefix: str = "") -> list[ObjectMeta]:
        return self._call("list", lambda: self.inner.list_objects(bucket, prefix))

    def delete(self, bucket: str, key: str) -> None:
        return self._call("delete", lambda: self.inner.delete(bucket, key))

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> MultipartUpload:
        return _WrappedMultipart(self, self.inner.multipart(bucket, key, metadata))

    def _commit_allowed(self) -> None:
        """Hook consulted by `_WrappedMultipart.complete()` before the
        (otherwise free) commit is issued. Raises to refuse. Chained down
        the stack so a kill switch anywhere below fences commits issued
        through sessions opened above it."""
        inner = getattr(self.inner, "_commit_allowed", None)
        if inner is not None:
            inner()


class _WrappedMultipart(MultipartUpload):
    """Routes part uploads of an inner session through the middleware.

    Part-indexed and thread-safe like the sessions it wraps: concurrent
    out-of-order `put_part(index, data)` calls each cross the middleware
    as their own PUT attempt (so a parallel part fan-out is throttled,
    delayed, billed, and retried per part, like real S3 UploadPart
    traffic)."""

    def __init__(self, mw: StoreMiddleware, inner: MultipartUpload):
        self._mw = mw
        self._inner = inner

    def put_part(self, index: int, data: bytes) -> None:
        self._mw._call("put", lambda: self._inner.put_part(index, data),
                       nbytes=len(data))

    def complete(self) -> ObjectMeta:  # free, like S3 CompleteMultipartUpload
        # Not billed/throttled, but still refused once the owning view is
        # dead: a commit that BEGINS after a kill switch trips can never
        # land, which makes request-budget kills pre-commit-deterministic
        # (abort still works — cleanup outlives the host).
        self._mw._commit_allowed()
        return self._inner.complete()

    def abort(self) -> None:
        self._inner.abort()


# ---------------------------------------------------------------------------
# Metrics: the PR-1 request accounting, now a layer
# ---------------------------------------------------------------------------


class MetricsMiddleware(StoreMiddleware):
    """Counts every attempt that crosses it into a StoreStats.

    Placed inside RetryMiddleware and outside ThrottlingMiddleware so the
    counters are retry-inflated: each throttled attempt and each re-issue
    is its own request, as it would be on a real S3 bill/rate budget.
    """

    def __init__(self, inner: StoreBackend, stats: StoreStats | None = None):
        super().__init__(inner)
        self.stats = stats if stats is not None else StoreStats()

    _COUNTER = {"get": "get_requests", "put": "put_requests",
                "head": "head_requests", "list": "list_requests",
                "delete": "delete_requests"}

    def _call(self, kind, issue, *, read=False, nbytes=0):
        field = self._COUNTER.get(kind)
        if field:
            self.stats.add(field, 1)
        try:
            result = issue()
        except SlowDown:
            self.stats.add("throttled", 1)
            raise
        if read:
            self.stats.add("bytes_read", len(result))
        if kind == "put":
            self.stats.add("bytes_written", nbytes)
        return result

    def stats_snapshot(self) -> StoreStats:
        """Consistent copy of the counters (for before/after deltas)."""
        return self.stats.snapshot()


# ---------------------------------------------------------------------------
# Tracing: per-attempt attribution to the issuing task (obs layer)
# ---------------------------------------------------------------------------


class TracingMiddleware(StoreMiddleware):
    """Attributes every request attempt to the task that issued it.

    The observability twin of MetricsMiddleware, and it sits at the same
    stack position (inside RetryMiddleware, outside the fault injectors)
    so its counts are retry-inflated bit-for-bit like the billed ones:
    every attempt — throttled, failed, or served — becomes one child
    span of the current TraceContext (obs/context.py) in the tracer's
    event log, and one `store.requests{kind,outcome[,tier]}` counter
    increment in its registry. Successful reads/writes also add to the
    phase-labeled `store.bytes_read` / `store.bytes_written` counters —
    the per-phase bytes/s the report's metrics derive from.

    Outcomes: "ok", "slowdown" (a 503 the retry layer will re-issue),
    "error" (anything else, e.g. a dead worker's severed store view).
    """

    def __init__(self, inner: StoreBackend, tracer: Tracer, *,
                 tier: str = ""):
        super().__init__(inner)
        self.tracer = tracer
        self.tier = tier

    def _record(self, kind: str, t0: float, outcome: str, nbytes: int,
                *, read: bool = False) -> None:
        reg = self.tracer.registry
        labels = {"kind": kind, "outcome": outcome}
        if self.tier:
            labels["tier"] = self.tier
        reg.counter("store.requests", 1, **labels)
        if outcome == "ok" and nbytes:
            ctx = current_context()
            blabels = {"phase": ctx.phase if ctx else ""}
            if self.tier:
                blabels["tier"] = self.tier
            reg.counter("store.bytes_read" if read else "store.bytes_written",
                        nbytes, **blabels)
        self.tracer.event(f"store.{kind}", t0, time.perf_counter(),
                          outcome=outcome, nbytes=nbytes,
                          tier=self.tier or None)

    def _call(self, kind, issue, *, read=False, nbytes=0):
        if kind == "bucket":  # not a billed request; Metrics skips it too
            return issue()
        t0 = time.perf_counter()
        try:
            result = issue()
        except SlowDown:
            self._record(kind, t0, "slowdown", 0)
            raise
        except BaseException:
            self._record(kind, t0, "error", 0)
            raise
        n = len(result) if read else nbytes
        self._record(kind, t0, "ok", n, read=read)
        return result


# ---------------------------------------------------------------------------
# Latency + bandwidth: the wire
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """S3-like service parameters for the fault-injecting middlewares.

    Zero disables a term. `latency_s` is per-request first-byte latency
    (S3 TTFB is ~10–50 ms); `bandwidth_bps` is per-request streaming
    throughput (~90 MB/s per S3 connection); `get_rate`/`put_rate` are
    token-bucket request rates per second with `burst` capacity (S3
    advertises 5500 GET/s and 3500 PUT/s per prefix before 503s).
    """

    latency_s: float = 0.0
    jitter_s: float = 0.0  # uniform extra latency in [0, jitter_s)
    bandwidth_bps: float = 0.0
    get_rate: float = 0.0
    put_rate: float = 0.0
    burst: float = 32.0


class LatencyBandwidthMiddleware(StoreMiddleware):
    """Sleeps each request by latency + bytes/bandwidth; accounts the stall.

    The sleep is taken with no lock held, so concurrent requests stall
    concurrently — which is precisely what the staging layer's pipelining
    is supposed to hide, and what bench_store_faults measures.
    """

    def __init__(self, inner: StoreBackend, profile: FaultProfile,
                 *, stats: StoreStats | None = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        super().__init__(inner)
        self.profile = profile
        self.stats = stats if stats is not None else StoreStats()
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()

    def _stall(self, seconds: float) -> None:
        if seconds <= 0:
            return
        self.stats.add("stall_seconds", seconds)
        self._sleep(seconds)

    def _call(self, kind, issue, *, read=False, nbytes=0):
        p = self.profile
        if kind != "bucket":
            if p.jitter_s:
                with self._rng_lock:
                    jitter = self._rng.uniform(0, p.jitter_s)
            else:
                jitter = 0.0
            pre = p.latency_s + jitter
            if nbytes and p.bandwidth_bps:
                pre += nbytes / p.bandwidth_bps  # upload streams before ack
            self._stall(pre)
        result = issue()
        if read and p.bandwidth_bps:
            self._stall(len(result) / p.bandwidth_bps)
        return result


# ---------------------------------------------------------------------------
# Throttling: the service's 503 budget
# ---------------------------------------------------------------------------


class _TokenBucket:
    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.capacity = max(float(burst), 1.0)
        self.tokens = self.capacity
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        if self.rate <= 0:  # unlimited
            return True
        with self._lock:
            now = self._clock()
            self.tokens = min(self.capacity,
                              self.tokens + (now - self._t) * self.rate)
            self._t = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class ThrottlingMiddleware(StoreMiddleware):
    """Token-bucket request admission; over-budget attempts raise SlowDown.

    Reads (get) and writes (put/delete) draw from separate buckets,
    mirroring S3's separate GET and PUT rate budgets per prefix. Metadata
    requests (head/list) are not throttled — they're free in Table 2 and
    effectively unlimited in practice.
    """

    def __init__(self, inner: StoreBackend, profile: FaultProfile,
                 *, clock: Callable[[], float] = time.monotonic):
        super().__init__(inner)
        self.profile = profile
        self._read_bucket = _TokenBucket(profile.get_rate, profile.burst, clock)
        self._write_bucket = _TokenBucket(profile.put_rate, profile.burst, clock)

    def _call(self, kind, issue, *, read=False, nbytes=0):
        bucket = None
        if kind == "get":
            bucket = self._read_bucket
        elif kind in ("put", "delete"):
            bucket = self._write_bucket
        if bucket is not None and not bucket.try_acquire():
            raise SlowDown(f"503 Slow Down ({kind})")
        return issue()


# ---------------------------------------------------------------------------
# Kill switch: emulated host death (core/cluster.py's failure domain)
# ---------------------------------------------------------------------------


class KillSwitchMiddleware(StoreMiddleware):
    """Emulated host death for one worker's view of a shared store.

    Once tripped — explicitly via `trip()` (core/cluster.FaultyWorker) or
    automatically after `fail_after_requests` served requests — every
    subsequent request raises `exc_factory()`. The exception should NOT
    be a RetryableError: a dead host does not come back on backoff, so
    the store-level retry stack must propagate it to the cluster driver,
    whose task re-execution is the correct recovery. Requests refused by
    a tripped switch never reach inner layers, so they are not billed or
    throttled — a dead worker stops generating traffic, it doesn't
    generate errors on the bill.
    """

    def __init__(self, inner: StoreBackend, *,
                 exc_factory: Callable[[], BaseException],
                 fail_after_requests: int | None = None):
        super().__init__(inner)
        self._exc_factory = exc_factory
        self._budget = fail_after_requests
        self._lock = threading.Lock()
        self._tripped = threading.Event()

    @property
    def tripped(self) -> bool:
        return self._tripped.is_set()

    def trip(self) -> None:
        self._tripped.set()

    def _call(self, kind, issue, *, read=False, nbytes=0):
        if self._tripped.is_set():
            raise self._exc_factory()
        if self._budget is not None and kind != "bucket":
            with self._lock:
                if self._budget <= 0:
                    self._tripped.set()
                else:
                    self._budget -= 1
            if self._tripped.is_set():
                raise self._exc_factory()
        return issue()

    def _commit_allowed(self) -> None:
        # Serialized with the budget decrement so a multipart complete
        # and the request that trips the switch are strictly ordered: a
        # commit starting after the trip is refused, never durable.
        with self._lock:
            if self._tripped.is_set():
                raise self._exc_factory()
        super()._commit_allowed()


# ---------------------------------------------------------------------------
# Retry: the client's backoff loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with multiplicative jitter (the AWS SDK
    default shape): attempt k sleeps min(base * 2^k, max_delay) scaled by
    a uniform factor in [1 - jitter, 1]."""

    max_attempts: int = 8  # total attempts, including the first
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    jitter: float = 0.5

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay_s * (2.0 ** attempt), self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())


class RetryMiddleware(StoreMiddleware):
    """Re-issues attempts that fail with a RetryableError (e.g. SlowDown).

    Sits outermost so each re-issue re-traverses metrics/throttling/
    latency — a retry is a brand-new request. When attempts are
    exhausted the *original* error propagates; `stats.retries` counts
    re-issues and `stats.stall_seconds` the backoff sleeps.
    """

    def __init__(self, inner: StoreBackend, policy: RetryPolicy = RetryPolicy(),
                 *, stats: StoreStats | None = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 tracer: Tracer | None = None):
        super().__init__(inner)
        self.policy = policy
        self.stats = stats if stats is not None else StoreStats()
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.tracer = tracer

    def _call(self, kind, issue, *, read=False, nbytes=0):
        attempt = 0
        while True:
            try:
                return issue()
            except RetryableError:
                attempt += 1
                if attempt >= self.policy.max_attempts:
                    raise
                with self._rng_lock:
                    delay = self.policy.delay(attempt - 1, self._rng)
                self.stats.add("retries", 1)
                self.stats.add("stall_seconds", delay)
                if self.tracer is not None:
                    self.tracer.registry.counter("store.retries", 1, kind=kind)
                    self.tracer.registry.observe("store.retry_delay_s", delay,
                                                 kind=kind)
                    self.tracer.instant("store.retry", kind=kind,
                                        attempt=attempt, delay_s=delay)
                self._sleep(delay)


def fault_injected(backend: StoreBackend, *, profile: FaultProfile,
                   retry: RetryPolicy | None = RetryPolicy(),
                   seed: int = 0, tracer: Tracer | None = None,
                   tier: str = "") -> StoreBackend:
    """Compose the canonical stack around `backend` with one shared
    StoreStats: Retry(Tracing?(Metrics(Throttle(Latency(backend))))).

    Pass `retry=None` to expose raw SlowDowns to the caller (tests, or a
    client that does its own backoff). With a `tracer`, a
    TracingMiddleware rides at the MetricsMiddleware position (inside
    Retry, outside the fault injectors) so per-task attribution counts
    the same retry-inflated attempts the bill does; `tier` labels its
    events (e.g. "durable" / "ssd"). The returned store duck-types the
    PR-1 ObjectStore: `.stats` / `.stats_snapshot()` reach the shared
    counters via attribute delegation.
    """
    stats = StoreStats()
    store: StoreBackend = LatencyBandwidthMiddleware(
        backend, profile, stats=stats, seed=seed)
    store = ThrottlingMiddleware(store, profile)
    store = MetricsMiddleware(store, stats=stats)
    if tracer is not None:
        store = TracingMiddleware(store, tracer, tier=tier)
    if retry is not None:
        store = RetryMiddleware(store, retry, stats=stats, seed=seed + 1,
                                tracer=tracer)
    return store
