"""Object-store I/O subsystem (paper §2.2–§2.5).

  backends     — StoreBackend protocol; filesystem + in-memory data planes
  middleware   — latency/bandwidth, 503 throttling, retry/backoff, metrics
                 layers composable over any backend
  tiered       — TieredStore: local-SSD spill tier + durable (S3-like) tier
  object_store — ObjectStore, the metrics-wrapped filesystem composition
                 (the PR-1 surface, unchanged for existing consumers)
  records      — interleaved (key, id, payload) record-block codec
  staging      — async double-buffered host<->device staging

`core/external_sort.py` composes these into the out-of-core CloudSort
driver: dataset size is bounded by store capacity, not HBM.
"""
from repro_torch.io.backends import (FilesystemBackend, IntegrityError,
                               MemoryBackend, MultipartUpload, ObjectMeta,
                               ObjectNotFound, RetryableError, SlowDown,
                               StoreBackend, StoreStats)
from repro_torch.io.middleware import (FaultProfile, LatencyBandwidthMiddleware,
                                 MetricsMiddleware, RetryMiddleware,
                                 RetryPolicy, StoreMiddleware,
                                 ThrottlingMiddleware, fault_injected)
from repro_torch.io.object_store import ObjectStore
from repro_torch.io.records import (body_range, decode_body, decode_header,
                              decode_records, encode_body, encode_header,
                              encode_records, record_bytes)
from repro_torch.io.staging import AsyncWriter, prefetch
from repro_torch.io.tiered import TieredStore, tiered_cloudsort_store

__all__ = [
    "FilesystemBackend", "IntegrityError", "MemoryBackend", "MultipartUpload",
    "ObjectMeta", "ObjectNotFound", "ObjectStore", "RetryableError",
    "SlowDown", "StoreBackend", "StoreStats",
    "FaultProfile", "LatencyBandwidthMiddleware", "MetricsMiddleware",
    "RetryMiddleware", "RetryPolicy", "StoreMiddleware",
    "ThrottlingMiddleware", "fault_injected",
    "TieredStore", "tiered_cloudsort_store",
    "body_range", "decode_body", "decode_header", "decode_records",
    "encode_body", "encode_header", "encode_records", "record_bytes",
    "AsyncWriter", "prefetch",
]
