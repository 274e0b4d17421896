"""ObjectStore: the PR-1 entry point, now a composition over io/backends.

Exoshuffle-CloudSort keeps the *entire* dataset in S3 (§2.2) and the TCO
model charges *per request* (§3.3.2, Table 2), so faithful request
accounting is part of the reproduction. PR 1 implemented that as one
concrete filesystem class; the I/O stack is now layered (the multi-layer
refactor of ISSUE 2):

  io/backends.py   — StoreBackend protocol + FilesystemBackend (the old
                     data plane, CRC-verified reads) + MemoryBackend
  io/middleware.py — Latency/Bandwidth, Throttling (503 Slow Down),
                     Retry (backoff), Metrics (the old `stats` counters)
  io/tiered.py     — TieredStore: local-SSD spill tier + durable tier

`ObjectStore(root)` keeps its PR-1 surface exactly — a metrics-wrapped
filesystem backend: put / put_multipart / get / get_range / get_chunks /
head / list_objects / delete, per-bucket persistent manifests, `.stats`
and `.stats_snapshot()` — so every existing consumer works unchanged,
while new code composes backends and middleware directly.
"""
from __future__ import annotations

from repro_torch.io.backends import (FilesystemBackend, IntegrityError,
                               MemoryBackend, MultipartUpload, ObjectMeta,
                               ObjectNotFound, RetryableError, SlowDown,
                               StoreBackend, StoreStats)
from repro_torch.io.middleware import MetricsMiddleware

__all__ = [
    "FilesystemBackend", "IntegrityError", "MemoryBackend", "MultipartUpload",
    "ObjectMeta", "ObjectNotFound", "ObjectStore", "RetryableError",
    "SlowDown", "StoreBackend", "StoreStats",
]


class ObjectStore(MetricsMiddleware):
    """One store = one S3 endpoint on the local filesystem, with request
    accounting — MetricsMiddleware(FilesystemBackend(root)).

    `root` and `chunk_size` resolve to the underlying backend via
    attribute delegation, so reopening (`ObjectStore(store.root)`) and
    per-call chunk sizing behave exactly as before the refactor.
    """

    def __init__(self, root: str, *, chunk_size: int = 4 << 20):
        super().__init__(FilesystemBackend(root, chunk_size=chunk_size))
