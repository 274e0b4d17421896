"""Store backends: the data plane under the S3-contract interface.

The paper's shuffle treats "storage" as three different things (§2.2–§2.3):
durable object storage for input/output (S3 — high latency, per-request
fees, 503 throttling), local SSD for spilled runs (fast, free, dies with
the worker), and whatever a test harness wants (memory). PR 1 hard-wired
all of them to one filesystem class; this module splits the contract from
the implementation so the same external-sort driver can run against any
of them, and so the middleware stack (io/middleware.py) can inject the
S3 behaviours — latency, bandwidth, throttling, retries, accounting —
around *any* backend.

Layering:

  StoreBackend (ABC)   — the S3 surface the paper exercises. Subclasses
      implement only the primitives (create_bucket, multipart, get,
      get_range, head, list_objects, delete); `put`, `put_multipart`
      and `get_chunks` are derived on the base class in terms of the
      primitives, so a middleware that intercepts the primitives
      automatically covers the derived calls too.

  FilesystemBackend    — PR 1's filesystem emulation (persistent JSON
      manifests, atomic object replace, CRC32 etags), minus accounting
      (now MetricsMiddleware's job).

  MemoryBackend        — dict-backed store for tests and as the "local
      SSD" tier when tmpfs-like speed is wanted without touching disk.

Writes go through multipart *sessions* (`multipart()` -> MultipartUpload):
parts are *part-indexed* (`put_part(index, data)`) and may arrive in any
order from any number of threads — exactly S3's UploadPart contract, where
part numbers decide assembly order and the wire order is free. `complete()`
assembles parts in ascending index order and computes the CRC etag in that
part order, so an object uploaded 3,1,2 in parallel is byte- and
etag-identical to the same parts uploaded sequentially. This is what lets
the reduce pass fan one partition's part uploads out over a pool instead
of threading them through a single ordered queue (core/external_sort.py).

Thread-safe: the staging layer issues puts/gets from background threads
to overlap I/O with device compute (§2.5), and concurrent `put_part`
calls of one session race only on distinct part slots (same-index
re-uploads are last-write-wins, like S3).
"""
from __future__ import annotations

import abc
import dataclasses
import itertools
import json
import os
import threading
import zlib

try:  # POSIX advisory locks guard cross-process manifest updates.
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None
from typing import Iterable, Iterator


class ObjectNotFound(KeyError):
    """Missing bucket or key (the S3 404)."""


class IntegrityError(RuntimeError):
    """Stored bytes do not match the manifest (size or CRC etag mismatch).

    A real error type, not an `assert` — corruption checks must survive
    `python -O`.
    """


class RetryableError(RuntimeError):
    """Transient store failure a client is expected to retry."""


class SlowDown(RetryableError):
    """S3 '503 Slow Down': request rate exceeded (io/middleware.py)."""


@dataclasses.dataclass
class StoreStats:
    """Cumulative request/byte counters — the measured Table-2 inputs.

    Request counters count *attempts issued*, so a GET that is throttled
    twice and then succeeds contributes 3 to `get_requests` — the
    retry-inflated count the cost model bills (an S3 retry is a new
    request). `throttled` / `retries` break the inflation out, and
    `stall_seconds` accumulates simulated network time injected by
    LatencyBandwidthMiddleware (summed across threads, so it can exceed
    wall time when requests overlap — that overhang is the overlap the
    staging layer hides).
    """

    get_requests: int = 0
    put_requests: int = 0
    head_requests: int = 0
    list_requests: int = 0
    delete_requests: int = 0  # free-tier priced, but tracked
    bytes_read: int = 0
    bytes_written: int = 0
    throttled: int = 0  # attempts rejected with SlowDown
    retries: int = 0  # re-issues performed by RetryMiddleware
    stall_seconds: float = 0.0  # simulated latency/bandwidth/backoff time

    def __post_init__(self):
        # One instance may be shared by several middleware layers writing
        # from staging threads; updates go through add()/snapshot() under
        # this lock (not a field — delta arithmetic below ignores it).
        object.__setattr__(self, "_lock", threading.Lock())

    def add(self, field: str, amount) -> None:
        """Atomic counter bump (thread-safe across sharing layers)."""
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def snapshot(self) -> "StoreStats":
        """Consistent copy of the counters (for before/after deltas)."""
        with self._lock:
            return StoreStats(**{
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
            })

    def __sub__(self, other: "StoreStats") -> "StoreStats":
        return StoreStats(**{
            f.name: getattr(self, f.name) - getattr(other, f.name)
            for f in dataclasses.fields(self)
        })

    def __add__(self, other: "StoreStats") -> "StoreStats":
        return StoreStats(**{
            f.name: getattr(self, f.name) + getattr(other, f.name)
            for f in dataclasses.fields(self)
        })

    # Pickled without its lock (a report crosses ranks as a pickle).
    def __getstate__(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        object.__setattr__(self, "_lock", threading.Lock())


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    """Manifest entry: what `head` returns (S3 HeadObject)."""

    key: str
    size: int
    etag: str  # crc32 of the object bytes
    parts: int  # 1 for plain puts, #parts for multipart uploads
    metadata: dict


def _check_key(key: str) -> str:
    # Real exceptions, not asserts: the path-traversal guard must survive
    # `python -O` (a ".."-segment key would escape the bucket directory).
    if not key or key.startswith(("/", ".")) or ".." in key.split("/"):
        raise ValueError(f"bad object key {key!r}")
    return key


def _verify_integrity(where: str, data: bytes, entry: dict) -> bytes:
    """Whole-object read check shared by every backend: size and CRC etag
    must match the manifest, as real exceptions (survives `python -O`)."""
    if len(data) != entry["size"]:
        raise IntegrityError(
            f"{where}: size {len(data)} != manifest {entry['size']}")
    if f"{zlib.crc32(data):08x}" != entry["etag"]:
        raise IntegrityError(f"{where}: CRC mismatch vs etag")
    return data


class MultipartUpload(abc.ABC):
    """An in-progress multipart upload (S3 CreateMultipartUpload session).

    `put_part(index, data)` is the billable unit (one PUT per part,
    §3.3.2's "40 chunks" reduce upload); initiate/complete are free,
    matching the paper's request arithmetic. Part indices are the S3 part
    numbers: parts may be uploaded out of order and concurrently,
    re-uploading an index is last-write-wins, and `complete()` assembles
    ascending-by-index (gaps are fine, as on S3) with the CRC etag
    computed in that assembled order. Parts become visible atomically at
    `complete()`; `abort()` discards them — including parts whose upload
    raced the abort.
    """

    @abc.abstractmethod
    def put_part(self, index: int, data: bytes) -> None: ...

    @abc.abstractmethod
    def complete(self) -> ObjectMeta: ...

    @abc.abstractmethod
    def abort(self) -> None: ...


class StoreBackend(abc.ABC):
    """The S3 surface (paper §2.2): one store = one endpoint.

    Subclasses provide the primitives; `put` / `put_multipart` /
    `get_chunks` are derived here so every byte flows through the
    primitives (and therefore through any wrapping middleware) exactly
    once. Instances expose `chunk_size`, the default ranged-GET
    granularity.
    """

    # Annotation only (no class attr): middleware resolves chunk_size via
    # attribute delegation to the wrapped backend instance.
    chunk_size: int

    # -- primitives (implement in backends, intercept in middleware) -------

    @abc.abstractmethod
    def create_bucket(self, bucket: str) -> None: ...

    @abc.abstractmethod
    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> MultipartUpload: ...

    @abc.abstractmethod
    def get(self, bucket: str, key: str) -> bytes: ...

    @abc.abstractmethod
    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes: ...

    @abc.abstractmethod
    def head(self, bucket: str, key: str) -> ObjectMeta: ...

    @abc.abstractmethod
    def list_objects(self, bucket: str, prefix: str = "") -> list[ObjectMeta]: ...

    @abc.abstractmethod
    def delete(self, bucket: str, key: str) -> None: ...

    # -- derived (never overridden by middleware) ---------------------------

    def put(self, bucket: str, key: str, data: bytes,
            metadata: dict | None = None) -> ObjectMeta:
        """S3 PutObject: one PUT request (a single-part session)."""
        mp = self.multipart(bucket, key, metadata)
        try:
            mp.put_part(0, bytes(data))
            return mp.complete()
        except BaseException:
            mp.abort()
            raise

    def put_multipart(self, bucket: str, key: str, parts: Iterable[bytes],
                      metadata: dict | None = None) -> ObjectMeta:
        """S3 multipart upload: one PUT request counted per part.

        `parts` may be a lazy iterable — each part streams to the backend
        as it is produced, so the whole object never has to exist in
        memory (the streaming reduce path).
        """
        mp = self.multipart(bucket, key, metadata)
        try:
            for idx, p in enumerate(parts):
                mp.put_part(idx, bytes(p))
            return mp.complete()
        except BaseException:
            mp.abort()
            raise

    def get_chunks(self, bucket: str, key: str,
                   chunk_size: int | None = None) -> Iterator[bytes]:
        """Download an object as ranged chunks — the paper's map download
        pattern (one GET per chunk, §3.3.2's "120 chunks" per map task).

        A zero-length object yields nothing and issues no GET, matching
        S3 (a ranged GET on an empty object is a 416, not a request a
        sane client pays for).
        """
        size = self.head(bucket, key).size
        step = int(chunk_size or self.chunk_size)
        assert step > 0
        for off in range(0, size, step):
            yield self.get_range(bucket, key, off, step)


# ---------------------------------------------------------------------------
# Filesystem backend (the PR-1 emulation, accounting removed)
# ---------------------------------------------------------------------------

_MANIFEST = "manifest.json"
_OBJECTS = "objects"


class FilesystemBackend(StoreBackend):
    """Buckets under `root`, objects as files, manifests as JSON.

    The manifest persists so a store can be reopened (the S3 namespace
    survives process death, unlike worker memory).

    Safe for concurrent writers in SEPARATE PROCESSES sharing one root:
    every manifest mutation is a read-modify-write of the on-disk JSON
    under an `fcntl` file lock, so two processes committing into the
    same bucket never lose each other's entries. The in-memory manifest
    is a cache of the disk state; reads reload it on a miss (an object
    another process put) and treat a vanished object file as a
    concurrent delete (`ObjectNotFound`) rather than a crash.
    """

    def __init__(self, root: str, *, chunk_size: int = 4 << 20):
        self.root = root
        self.chunk_size = int(chunk_size)
        self._lock = threading.Lock()
        self._manifests: dict[str, dict[str, dict]] = {}
        self._flush_locks: dict[str, threading.Lock] = {}
        os.makedirs(root, exist_ok=True)
        for bucket in sorted(os.listdir(root)):
            mpath = os.path.join(root, bucket, _MANIFEST)
            if os.path.isfile(mpath):
                with open(mpath) as f:
                    self._manifests[bucket] = json.load(f)
                self._flush_locks[bucket] = threading.Lock()

    # -- namespace ---------------------------------------------------------

    def create_bucket(self, bucket: str) -> None:
        os.makedirs(os.path.join(self.root, bucket, _OBJECTS), exist_ok=True)
        with self._lock:
            self._manifests.setdefault(bucket, {})
            self._flush_locks.setdefault(bucket, threading.Lock())
        # Merge-with-disk no-op: registers the bucket without clobbering
        # a manifest another process already populated.
        self._mutate_manifest(bucket, lambda manifest: None)

    def _object_path(self, bucket: str, key: str) -> str:
        return os.path.join(self.root, bucket, _OBJECTS, *_check_key(key).split("/"))

    def _bucket_known(self, bucket: str) -> bool:
        """True if the bucket exists here or was created by another
        process against the same root (registers it locally if so)."""
        if bucket in self._manifests:
            return True
        if not os.path.isdir(os.path.join(self.root, bucket, _OBJECTS)):
            return False
        with self._lock:
            self._manifests.setdefault(bucket, {})
            self._flush_locks.setdefault(bucket, threading.Lock())
        self._reload_manifest(bucket)
        return True

    def _mutate_manifest(self, bucket: str, fn) -> None:
        """Cross-process read-modify-write of the bucket manifest.

        The on-disk JSON is the source of truth: under an exclusive
        `fcntl` lock we load it, apply `fn(manifest)`, dump atomically,
        and refresh the in-memory cache. A per-bucket thread lock keeps
        same-process mutators from contending on the file lock."""
        mpath = os.path.join(self.root, bucket, _MANIFEST)
        lockpath = mpath + ".lock"
        with self._flush_locks[bucket]:
            with open(lockpath, "a") as lockf:
                if fcntl is not None:
                    fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    try:
                        with open(mpath) as f:
                            manifest = json.load(f)
                    except (FileNotFoundError, json.JSONDecodeError):
                        manifest = {}
                    fn(manifest)
                    tmp = f"{mpath}.{os.getpid()}-{threading.get_ident()}.tmp"
                    with open(tmp, "w") as f:
                        json.dump(manifest, f)
                    os.replace(tmp, mpath)
                    with self._lock:
                        self._manifests[bucket] = manifest
                finally:
                    if fcntl is not None:
                        fcntl.flock(lockf, fcntl.LOCK_UN)

    def _reload_manifest(self, bucket: str) -> None:
        """Refresh the cached manifest from disk (another process may
        have committed since we last looked). Atomic `os.replace` on the
        writer side means we read a consistent snapshot or nothing."""
        mpath = os.path.join(self.root, bucket, _MANIFEST)
        try:
            with open(mpath) as f:
                fresh = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return
        with self._lock:
            self._manifests[bucket] = fresh

    def _entry(self, bucket: str, key: str) -> dict:
        try:
            return self._manifests[bucket][key]
        except KeyError:
            pass
        self._reload_manifest(bucket)
        try:
            return self._manifests[bucket][key]
        except KeyError:
            raise ObjectNotFound(f"{bucket}/{key}") from None

    @staticmethod
    def _meta(key: str, e: dict) -> ObjectMeta:
        return ObjectMeta(key=key, size=e["size"], etag=e["etag"],
                          parts=e["parts"], metadata=dict(e["metadata"]))

    # -- writes ------------------------------------------------------------

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> "_FsMultipart":
        if not self._bucket_known(bucket):
            raise ObjectNotFound(bucket)
        return _FsMultipart(self, bucket, key, metadata)

    def _commit(self, bucket: str, key: str, entry: dict) -> ObjectMeta:
        self._mutate_manifest(bucket,
                              lambda manifest: manifest.__setitem__(key, entry))
        return self._meta(key, entry)

    # -- reads -------------------------------------------------------------

    def _read_object(self, bucket: str, key: str, entry: dict, reader):
        """Run `reader(open file, entry)` surviving a concurrent
        cross-process delete: a vanished file means the cached entry was
        stale — reload, then either retry against the re-created object
        or report it gone."""
        path = self._object_path(bucket, key)
        try:
            with open(path, "rb") as f:
                return reader(f, entry)
        except FileNotFoundError:
            self._reload_manifest(bucket)
            fresh = self._manifests.get(bucket, {}).get(key)
            if fresh is None:
                raise ObjectNotFound(f"{bucket}/{key}") from None
            try:
                with open(path, "rb") as f:
                    return reader(f, fresh)
            except FileNotFoundError:
                raise ObjectNotFound(f"{bucket}/{key}") from None

    def get(self, bucket: str, key: str) -> bytes:
        """S3 GetObject (whole object), CRC-etag verified end to end."""
        def whole(f, e):
            return _verify_integrity(f"{bucket}/{key}", f.read(), e)
        return self._read_object(bucket, key, self._entry(bucket, key), whole)

    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes:
        """S3 ranged GET; truncates at object end like S3."""
        def ranged(f, e):
            lo = max(int(start), 0)
            f.seek(lo)
            return f.read(min(int(length), max(e["size"] - lo, 0)))
        return self._read_object(bucket, key, self._entry(bucket, key), ranged)

    # -- metadata ----------------------------------------------------------

    def head(self, bucket: str, key: str) -> ObjectMeta:
        return self._meta(key, self._entry(bucket, key))

    def list_objects(self, bucket: str, prefix: str = "") -> list[ObjectMeta]:
        if not self._bucket_known(bucket):
            raise ObjectNotFound(bucket)
        self._reload_manifest(bucket)  # see cross-process writes
        with self._lock:
            items = sorted(self._manifests[bucket].items())
        return [self._meta(k, e) for k, e in items if k.startswith(prefix)]

    def delete(self, bucket: str, key: str) -> None:
        self._entry(bucket, key)
        removed = []

        def drop(manifest):
            if manifest.pop(key, None) is not None:
                removed.append(key)

        # Manifest entry first, object file second: a reader holding a
        # stale cache either still finds the bytes (valid data) or hits
        # FileNotFoundError and resolves it via `_read_object`.
        self._mutate_manifest(bucket, drop)
        if not removed:
            raise ObjectNotFound(f"{bucket}/{key}")
        try:
            os.remove(self._object_path(bucket, key))
        except FileNotFoundError:
            pass


# Session nonces keep concurrent sessions for the same key from sharing
# tmp paths (the old thread-id scheme collided for same-thread sessions).
# The pid qualifier extends that to concurrent sessions in different
# processes — e.g. a speculative duplicate of a reduce task racing the
# original on the same output key.
_MP_NONCE = itertools.count()


class _FsMultipart(MultipartUpload):
    """Each part lands in its own tmp file (so concurrent out-of-order
    `put_part` calls never share a write path); `complete` streams the
    parts together ascending-by-index — CRC etag computed in that order,
    the S3 server-side assembly — and promotes the result atomically."""

    def __init__(self, backend: FilesystemBackend, bucket: str, key: str,
                 metadata: dict | None):
        self._b = backend
        self._bucket = bucket
        self._key = key
        self._metadata = dict(metadata or {})
        path = backend._object_path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._path = path
        self._tmp = f"{path}.{os.getpid()}-{next(_MP_NONCE)}.mp"
        self._lock = threading.Lock()
        # index -> (part tmp file, size, crc32): size/crc are computed at
        # upload time so a single-part complete() never re-reads the data.
        self._parts: dict[int, tuple[str, int, int]] = {}

    def _part_path(self, index: int) -> str:
        return f"{self._tmp}.part-{int(index):05d}"

    def put_part(self, index: int, data: bytes) -> None:
        index = int(index)
        if index < 0:
            raise ValueError(f"part index must be >= 0, got {index}")
        final = self._part_path(index)
        # Write-then-replace: a same-index re-upload is atomic last-write-
        # wins even when two uploaders race on the slot (S3 semantics).
        staged = f"{final}.{threading.get_ident()}.w"
        with open(staged, "wb") as f:
            f.write(data)
        os.replace(staged, final)
        with self._lock:
            self._parts[index] = (final, len(data), zlib.crc32(data))

    def complete(self) -> ObjectMeta:
        with self._lock:
            parts = sorted(self._parts.items())
        if len(parts) == 1:
            # Plain puts and single-part sessions — all spill and gensort
            # traffic — promote the part file directly: one disk write
            # total, no assembly copy or CRC re-read.
            _, (ppath, size, crc) = parts[0]
            self._clear_emptied_dir()
            os.replace(ppath, self._path)
        else:
            crc, size = 0, 0
            assembled = f"{self._tmp}.obj"
            with open(assembled, "wb") as out:
                for _, (ppath, _, _) in parts:
                    with open(ppath, "rb") as f:
                        data = f.read()
                    out.write(data)
                    crc = zlib.crc32(data, crc)
                    size += len(data)
            self._clear_emptied_dir()
            os.replace(assembled, self._path)
            for _, (ppath, _, _) in parts:
                if os.path.exists(ppath):
                    os.remove(ppath)
        entry = {"size": size, "etag": f"{crc:08x}",
                 "parts": max(len(parts), 1), "metadata": self._metadata}
        return self._b._commit(self._bucket, self._key, entry)

    def _clear_emptied_dir(self) -> None:
        """Make room for the object file where a directory of the same
        name stands: the directory that the key's children (`<key>/...`)
        left behind once they were deleted, as a recursive sort's earlier
        run leaves `part-X/sub-Y/`. `delete` removes files only, so the
        empty directory outlives them.

        This cannot race with a concurrent writer: `os.rmdir` is atomic
        and removes only an empty directory, and a writer of a key under
        `<key>/` keeps its part files in that directory until its own
        `complete`, so a live child upload is never removed. A child
        session that has made the directory but not yet written a part
        is a write of `<key>/...` beside the object `<key>`, which this
        backend cannot hold in any case (a file and a directory cannot
        share a path)."""
        if not os.path.isdir(self._path):
            return
        try:
            os.rmdir(self._path)
        except OSError as e:
            raise ValueError(
                f"{self._bucket}/{self._key}: cannot write the object where "
                f"objects under '{self._key}/' still exist") from e

    def abort(self) -> None:
        # Sweep by registry AND by tmp-prefix glob: a put_part racing the
        # abort may have written its file but not yet registered it.
        with self._lock:
            paths = {p for p, _, _ in self._parts.values()}
            self._parts.clear()
        parent = os.path.dirname(self._tmp)
        prefix = os.path.basename(self._tmp)
        if os.path.isdir(parent):
            paths.update(os.path.join(parent, name)
                         for name in os.listdir(parent)
                         if name.startswith(prefix))
        for p in paths:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


# ---------------------------------------------------------------------------
# Memory backend (tests; also a zero-latency "local SSD" tier)
# ---------------------------------------------------------------------------


class MemoryBackend(StoreBackend):
    """Dict-backed store: same contract, no filesystem."""

    def __init__(self, *, chunk_size: int = 4 << 20):
        self.chunk_size = int(chunk_size)
        self._lock = threading.Lock()
        self._buckets: dict[str, dict[str, tuple[bytes, dict]]] = {}

    def create_bucket(self, bucket: str) -> None:
        with self._lock:
            self._buckets.setdefault(bucket, {})

    def _entry(self, bucket: str, key: str) -> tuple[bytes, dict]:
        try:
            return self._buckets[bucket][key]
        except KeyError:
            raise ObjectNotFound(f"{bucket}/{key}") from None

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> "_MemMultipart":
        if bucket not in self._buckets:
            raise ObjectNotFound(bucket)
        return _MemMultipart(self, bucket, _check_key(key), metadata)

    def get(self, bucket: str, key: str) -> bytes:
        data, e = self._entry(bucket, key)
        return _verify_integrity(f"{bucket}/{key}", data, e)

    def get_range(self, bucket: str, key: str, start: int, length: int) -> bytes:
        data, _ = self._entry(bucket, key)
        start = max(int(start), 0)
        return data[start : start + max(int(length), 0)]

    def head(self, bucket: str, key: str) -> ObjectMeta:
        _, e = self._entry(bucket, key)
        return ObjectMeta(key=key, size=e["size"], etag=e["etag"],
                          parts=e["parts"], metadata=dict(e["metadata"]))

    def list_objects(self, bucket: str, prefix: str = "") -> list[ObjectMeta]:
        if bucket not in self._buckets:
            raise ObjectNotFound(bucket)
        with self._lock:
            items = sorted(self._buckets[bucket].items())
        return [
            ObjectMeta(key=k, size=e["size"], etag=e["etag"], parts=e["parts"],
                       metadata=dict(e["metadata"]))
            for k, (_, e) in items if k.startswith(prefix)
        ]

    def delete(self, bucket: str, key: str) -> None:
        self._entry(bucket, key)
        with self._lock:
            del self._buckets[bucket][key]


class _MemMultipart(MultipartUpload):
    """Index-keyed part dict; `complete` joins ascending-by-index."""

    def __init__(self, backend: MemoryBackend, bucket: str, key: str,
                 metadata: dict | None):
        self._b = backend
        self._bucket = bucket
        self._key = key
        self._metadata = dict(metadata or {})
        self._lock = threading.Lock()
        self._parts: dict[int, bytes] = {}

    def put_part(self, index: int, data: bytes) -> None:
        index = int(index)
        if index < 0:
            raise ValueError(f"part index must be >= 0, got {index}")
        with self._lock:
            self._parts[index] = bytes(data)  # last-write-wins per slot

    def complete(self) -> ObjectMeta:
        with self._lock:
            parts = sorted(self._parts.items())
        data = b"".join(p for _, p in parts)
        entry = {"size": len(data), "etag": f"{zlib.crc32(data):08x}",
                 "parts": max(len(parts), 1), "metadata": self._metadata}
        with self._b._lock:
            self._b._buckets[self._bucket][self._key] = (data, entry)
        return ObjectMeta(key=self._key, size=entry["size"], etag=entry["etag"],
                          parts=entry["parts"], metadata=dict(self._metadata))

    def abort(self) -> None:
        with self._lock:
            self._parts.clear()
