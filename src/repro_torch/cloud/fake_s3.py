"""FakeS3Backend: an in-process S3 double for the cloud code paths.

The real backends (cloud/remote.py) need credentials, a network, and
optional dependencies the CI container doesn't have — so CI exercises
the cloud-facing code against THIS backend instead: a dict-backed store
that speaks the same wire-level semantics the repo's S3 contract pins
(ranged GETs with past-EOF truncation, part-indexed multipart with
out-of-order assembly and last-write-wins slots, crc32 etags computed
in ascending-part order, atomic complete / sweeping abort) plus the two
S3 behaviours the local planes deliberately don't model:

  * SlowDown 503s — `slowdown_every=N` raises io.backends.SlowDown on
    every Nth data-plane attempt (GET, ranged GET, UploadPart), counted
    by a global attempt counter so the total throttle count for a run
    is a deterministic function of the attempt count, independent of
    thread interleaving (a throttled attempt that gets retried is
    itself an attempt, exactly like a real 503 regime). Metadata
    requests (HEAD/LIST/DELETE) are never throttled here — per-request
    injection for those is io/middleware.ThrottlingMiddleware's job.

  * multipart minimum-part-size — `min_part_bytes=B` rejects
    `complete()` when any part except the highest-indexed one is
    smaller than B (the S3 EntityTooSmall rule: only the last part may
    be short). The default 0 disables the check, matching the local
    planes the shuffle's spill traffic already runs against.

Knob validation raises ValueError naming the knob (the repo-wide
convention), never an assert — it must survive python -O.
"""
from __future__ import annotations

import threading

from repro_torch.io.backends import (MemoryBackend, ObjectNotFound, SlowDown,
                               _check_key, _MemMultipart)


class FakeS3Backend(MemoryBackend):
    """In-process S3 double (see module docstring).

    Subclasses MemoryBackend so the storage semantics (etag rules,
    multipart assembly, atomicity) are the contract implementation
    itself — the fake can never drift from the plane the compliance
    suite pins — and layers the S3-only behaviours on top.
    """

    def __init__(self, *, chunk_size: int = 4 << 20,
                 slowdown_every: int = 0, min_part_bytes: int = 0):
        if int(slowdown_every) < 0:
            raise ValueError(
                f"slowdown_every={slowdown_every!r}: must be >= 0 "
                "(0 disables SlowDown injection)")
        if int(min_part_bytes) < 0:
            raise ValueError(
                f"min_part_bytes={min_part_bytes!r}: must be >= 0 "
                "(0 disables the EntityTooSmall check)")
        super().__init__(chunk_size=chunk_size)
        self.slowdown_every = int(slowdown_every)
        self.min_part_bytes = int(min_part_bytes)
        self._attempt_lock = threading.Lock()
        self._data_attempts = 0
        self.throttled = 0

    def _throttle(self, what: str) -> None:
        """Every Nth data-plane attempt 503s, deterministically: the
        attempt counter is global, so for L logical requests retried to
        completion the totals satisfy attempts = L + throttled and
        throttled = floor(attempts / N) — a fixed point independent of
        the interleaving that produced it."""
        if not self.slowdown_every:
            return
        with self._attempt_lock:
            self._data_attempts += 1
            if self._data_attempts % self.slowdown_every == 0:
                self.throttled += 1
                raise SlowDown(f"503 Slow Down ({what})")

    # -- data plane (throttled) ---------------------------------------------

    def get(self, bucket: str, key: str) -> bytes:
        self._throttle(f"GET {bucket}/{key}")
        return super().get(bucket, key)

    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes:
        self._throttle(f"GET(range) {bucket}/{key}")
        return super().get_range(bucket, key, start, length)

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> "_FakeS3Multipart":
        if bucket not in self._buckets:
            raise ObjectNotFound(bucket)
        return _FakeS3Multipart(self, bucket, _check_key(key), metadata)


class _FakeS3Multipart(_MemMultipart):
    """_MemMultipart plus the S3-only wire rules: each UploadPart is a
    throttleable data-plane attempt, and complete() enforces the
    minimum-part-size constraint (every part but the highest-indexed
    must meet `min_part_bytes` — S3's EntityTooSmall)."""

    def put_part(self, index: int, data: bytes) -> None:
        self._b._throttle(f"UploadPart {self._bucket}/{self._key}")
        super().put_part(index, data)

    def complete(self):
        floor = self._b.min_part_bytes
        if floor:
            with self._lock:
                parts = sorted(self._parts.items())
            for idx, part in parts[:-1]:
                if len(part) < floor:
                    raise ValueError(
                        f"min_part_bytes={floor}: part {idx} is "
                        f"{len(part)} bytes — EntityTooSmall (every part "
                        "except the last must meet the minimum)")
        return super().complete()


__all__ = ["FakeS3Backend"]
