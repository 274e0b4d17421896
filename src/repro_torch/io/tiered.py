"""Tiered store: local-SSD spill tier + durable (S3-like) tier (§2.3).

The paper's storage split that PR 1 glossed over: map outputs spill to
*local NVMe SSD* (fast, free, dies with the worker), while job input and
output live in *S3* (slow, throttled, billed per request). A TieredStore
routes by key prefix — spill keys to the SSD tier, everything else to the
durable tier — so the same external-sort driver exercises both cost
regimes, and the cost model can price the durable tier's requests alone
(core/cost_model.measured_tiered_cloudsort_tco) instead of billing spill
traffic as S3 traffic.

Both tiers are plain StoreBackends (usually metrics-wrapped, the durable
one usually fault-injected too); `per_tier_stats()` exposes each tier's
counters and `stats_snapshot()` their sum, so existing consumers that
expect one StoreStats delta keep working unchanged.

Multipart sessions route whole: `multipart(bucket, key)` returns the
owning tier's session directly, so part-indexed out-of-order parallel
part uploads (io/backends.MultipartUpload) flow through the tier's own
middleware stack — durable-tier parts are throttled/billed per part,
SSD-tier parts are free — with no extra layer in between.

How the external-sort plan knobs (core/external_sort.ExternalSortPlan)
split across the tiers:

  merge_chunk_bytes / reduce_memory_budget_bytes — reduce-side ranged
      GETs hit the SSD tier (spilled runs live under spill_prefix), so
      the budget governor's chunk sizing trades *SSD* request count
      against memory; it never changes the durable bill. The knobs'
      memory invariant (all-reducer decoded peak <= budget) is
      tier-independent.

  parallel_reducers / part_upload_fanout — output partitions are durable-
      tier multipart uploads: PUT attempts (and 503/retry inflation)
      scale with parallel_reducers x part_upload_fanout, and those are
      exactly the requests measured_tiered_cloudsort_tco bills. Spill
      PUTs from map workers stay on the free SSD tier at any fan-out.
"""
from __future__ import annotations

from typing import Iterable, Sequence

from repro_torch.io.backends import (FilesystemBackend, MultipartUpload, ObjectMeta,
                               StoreBackend, StoreStats)
from repro_torch.io.middleware import (FaultProfile, MetricsMiddleware, RetryPolicy,
                                 TracingMiddleware, fault_injected)
from repro_torch.obs.events import Tracer


class TieredStore(StoreBackend):
    """Prefix-routed composition of an SSD tier and a durable tier.

    Keys under any of `ssd_prefixes` live in `ssd`; all other keys live
    in `durable`. `list_objects` merges the two namespaces (key-sorted)
    when the queried prefix spans both. A key can only ever live in one
    tier, so there is no shadowing to resolve.
    """

    def __init__(self, durable: StoreBackend, ssd: StoreBackend,
                 *, ssd_prefixes: Sequence[str] = ("spill/",)):
        self.durable = durable
        self.ssd = ssd
        self.ssd_prefixes = tuple(ssd_prefixes)
        assert all(self.ssd_prefixes), "empty ssd prefix would swallow every key"

    def _tier(self, key: str) -> StoreBackend:
        return self.ssd if key.startswith(self.ssd_prefixes) else self.durable

    @property
    def chunk_size(self) -> int:
        return self.durable.chunk_size

    # -- primitives, routed ------------------------------------------------

    def create_bucket(self, bucket: str) -> None:
        self.durable.create_bucket(bucket)
        self.ssd.create_bucket(bucket)

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> MultipartUpload:
        return self._tier(key).multipart(bucket, key, metadata)

    def get(self, bucket: str, key: str) -> bytes:
        return self._tier(key).get(bucket, key)

    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes:
        return self._tier(key).get_range(bucket, key, start, length)

    def head(self, bucket: str, key: str) -> ObjectMeta:
        return self._tier(key).head(bucket, key)

    def delete(self, bucket: str, key: str) -> None:
        self._tier(key).delete(bucket, key)

    def list_objects(self, bucket: str, prefix: str = "") -> list[ObjectMeta]:
        in_ssd = prefix.startswith(self.ssd_prefixes)
        metas: list[ObjectMeta] = []
        if not in_ssd:
            metas += self.durable.list_objects(bucket, prefix)
        if in_ssd or any(p.startswith(prefix) for p in self.ssd_prefixes):
            # Defensive filter: only surface keys that route to the SSD
            # tier, in case someone wrote foreign keys into it directly.
            metas += [m for m in self.ssd.list_objects(bucket, prefix)
                      if m.key.startswith(self.ssd_prefixes)]
        return sorted(metas, key=lambda m: m.key)

    # -- accounting --------------------------------------------------------

    def per_tier_stats(self) -> dict[str, StoreStats]:
        """{'durable': ..., 'ssd': ...} snapshots (zeros for an unmetered
        tier) — the separate legs the tiered cost model prices."""
        out = {}
        for name, tier in (("durable", self.durable), ("ssd", self.ssd)):
            snap = getattr(tier, "stats_snapshot", None)
            out[name] = snap() if snap else StoreStats()
        return out

    def stats_snapshot(self) -> StoreStats:
        """Sum over tiers — keeps single-StoreStats consumers working."""
        per = self.per_tier_stats()
        return per["durable"] + per["ssd"]


def tiered_cloudsort_store(
    root: str,
    *,
    spill_prefixes: Iterable[str] = ("spill/",),
    faults: FaultProfile | None = None,
    retry: RetryPolicy | None = None,
    chunk_size: int = 4 << 20,
    seed: int = 0,
    tracer: Tracer | None = None,
) -> TieredStore:
    """The paper's storage layout on one machine: a fault-injected durable
    tier at `root`/durable and a raw fast tier at `root`/ssd.

    With `faults=None` the durable tier is just metrics-wrapped (clean
    baseline for overlap benchmarks); otherwise it gets the full
    Retry(Metrics(Throttle(Latency(fs)))) stack (`retry` defaults to
    RetryPolicy() when faults are injected). The SSD tier is always
    metrics-only — local NVMe has neither request fees nor 503s. With a
    `tracer` (obs/events.Tracer) each tier also carries a
    TracingMiddleware, tier-labelled "durable" / "ssd", so every request
    attempt lands on the issuing task's trace as a tier-tagged child
    span.
    """
    import os

    durable_fs = FilesystemBackend(os.path.join(root, "durable"),
                                   chunk_size=chunk_size)
    if faults is None:
        durable: StoreBackend = MetricsMiddleware(durable_fs)
        if tracer is not None:
            durable = TracingMiddleware(durable, tracer, tier="durable")
    else:
        durable = fault_injected(
            durable_fs, profile=faults,
            retry=RetryPolicy() if retry is None else retry, seed=seed,
            tracer=tracer, tier="durable")
    ssd: StoreBackend = MetricsMiddleware(
        FilesystemBackend(os.path.join(root, "ssd"), chunk_size=chunk_size))
    if tracer is not None:
        ssd = TracingMiddleware(ssd, tracer, tier="ssd")
    return TieredStore(durable, ssd, ssd_prefixes=tuple(spill_prefixes))
