"""Real object-store backends behind the repo's StoreBackend protocol.

`S3Backend` (boto3) and `GCSBackend` (gcsfs) put the shuffle on actual
cloud storage: same seven primitives, same part-indexed multipart with
out-of-order / last-write-wins parts, same ranged-GET truncation at
EOF. The optional dependencies are NOT baked into the CI container, so
the imports are gated: constructing a backend without its client
library raises `ValueError` naming the pip extra (the repo's
knob-naming convention — the dependency is just another knob the caller
got wrong), and points at `FakeS3Backend` for hermetic runs. Only that
gating path is exercised in CI; every network-touching method is
`# pragma: no cover` by construction and validated against the same
compliance suite (tests/store_compliance.py) when run out-of-container
with credentials.

Contract notes where the real services diverge from the local planes:

  * etag — local planes define etag = crc32 of the assembled bytes.
    S3's multipart ETag is md5-of-part-md5s + "-N"; GCS reports crc32c.
    Both are deterministic functions of (part bytes, part order), which
    is what the compliance contract actually relies on (out-of-order
    uploads of identical parts produce identical etags); cross-PLANE
    etag equality is not promised for real backends, and the shuffle
    never compares etags across stores.
  * custom metadata — JSON-encoded into one user-metadata entry
    (`repro-meta`) because S3/GCS metadata values must be strings; part
    counts ride along as `repro-parts` where the service API cannot
    report them (GCS compose).
  * multipart minimums — S3 rejects non-final parts < 5 MiB
    (EntityTooSmall). The shuffle's spill/output parts are sized by
    `output_part_records`/`merge_chunk_bytes`, which the caller must
    keep >= 5 MiB on real S3; `FakeS3Backend(min_part_bytes=...)`
    exists precisely so CI can pin the failure mode.
"""
from __future__ import annotations

import json
import threading

from repro_torch.io.backends import (MultipartUpload, ObjectMeta, ObjectNotFound,
                               StoreBackend, _check_key)

_META_KEY = "repro-meta"
_PARTS_KEY = "repro-parts"


def _require_dep(module: str, backend: str, extra: str):
    """Gated import: a missing optional dependency is a configuration
    error named like any other bad knob, not an ImportError at some
    arbitrary call depth."""
    try:
        return __import__(module)
    except ImportError as exc:
        raise ValueError(
            f"{backend} requires the optional dependency {module!r} which is "
            f"not installed: pip install {extra} (or use "
            "repro_torch.cloud.FakeS3Backend, which speaks the same wire-level "
            "semantics in-process)") from exc


def _encode_meta(metadata: dict | None) -> dict:
    return {_META_KEY: json.dumps(dict(metadata or {}), sort_keys=True)}


def _decode_meta(raw: dict | None) -> dict:
    try:
        return json.loads((raw or {}).get(_META_KEY, "{}"))
    except (TypeError, json.JSONDecodeError):  # pragma: no cover
        return {}


# ---------------------------------------------------------------------------
# S3 (boto3)
# ---------------------------------------------------------------------------


class S3Backend(StoreBackend):
    """Amazon S3 (or any S3-compatible endpoint) via boto3.

    `client` may be injected (a stubbed/moto client, or one configured
    with custom retries); otherwise a default `boto3.client("s3")` is
    built — which requires boto3, credentials, and a network.
    """

    def __init__(self, *, region_name: str | None = None,
                 endpoint_url: str | None = None,
                 chunk_size: int = 4 << 20, client=None):
        if client is None:
            boto3 = _require_dep("boto3", "S3Backend", "boto3")
            client = boto3.client(  # pragma: no cover - needs network/creds
                "s3", region_name=region_name, endpoint_url=endpoint_url)
        self._s3 = client
        self.chunk_size = int(chunk_size)

    # -- namespace ----------------------------------------------------- #

    def create_bucket(self, bucket: str) -> None:  # pragma: no cover
        try:
            self._s3.create_bucket(Bucket=bucket)
        except (self._s3.exceptions.BucketAlreadyOwnedByYou,
                self._s3.exceptions.BucketAlreadyExists):
            pass

    # -- writes -------------------------------------------------------- #

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> "_S3Multipart":  # pragma: no cover
        return _S3Multipart(self, bucket, _check_key(key), metadata)

    # -- reads --------------------------------------------------------- #

    def get(self, bucket: str, key: str) -> bytes:  # pragma: no cover
        try:
            return self._s3.get_object(Bucket=bucket, Key=key)["Body"].read()
        except self._s3.exceptions.NoSuchKey:
            raise ObjectNotFound(f"{bucket}/{key}") from None

    def get_range(self, bucket: str, key: str,
                  start: int, length: int) -> bytes:  # pragma: no cover
        start = max(int(start), 0)
        if int(length) <= 0:
            return b""
        try:
            resp = self._s3.get_object(
                Bucket=bucket, Key=key,
                Range=f"bytes={start}-{start + int(length) - 1}")
        except self._s3.exceptions.ClientError as exc:
            code = exc.response.get("Error", {}).get("Code", "")
            if code in ("InvalidRange", "416"):
                return b""  # whole range past EOF truncates to empty
            if code in ("NoSuchKey", "404"):
                raise ObjectNotFound(f"{bucket}/{key}") from None
            raise
        return resp["Body"].read()

    # -- metadata ------------------------------------------------------ #

    def head(self, bucket: str, key: str) -> ObjectMeta:  # pragma: no cover
        try:
            resp = self._s3.head_object(Bucket=bucket, Key=key)
        except self._s3.exceptions.ClientError as exc:
            if exc.response.get("Error", {}).get("Code") in ("404", "NoSuchKey"):
                raise ObjectNotFound(f"{bucket}/{key}") from None
            raise
        return self._meta(key, resp)

    @staticmethod
    def _meta(key: str, resp: dict) -> ObjectMeta:  # pragma: no cover
        etag = resp.get("ETag", "").strip('"')
        # Multipart ETags carry the part count as an "-N" suffix.
        parts = int(etag.rsplit("-", 1)[1]) if "-" in etag else 1
        return ObjectMeta(key=key, size=int(resp["ContentLength"]), etag=etag,
                          parts=parts, metadata=_decode_meta(resp.get("Metadata")))

    def list_objects(self, bucket: str,
                     prefix: str = "") -> list[ObjectMeta]:  # pragma: no cover
        out = []
        paginator = self._s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                # One HEAD per key: ListObjectsV2 carries no user
                # metadata, and the shuffle's manifest scan (spill
                # offsets) lives there. Billed accordingly.
                out.append(self.head(bucket, obj["Key"]))
        return sorted(out, key=lambda m: m.key)

    def delete(self, bucket: str, key: str) -> None:  # pragma: no cover
        self.head(bucket, key)  # repo contract: deleting a missing key raises
        self._s3.delete_object(Bucket=bucket, Key=key)


class _S3Multipart(MultipartUpload):  # pragma: no cover - needs network
    """S3 CreateMultipartUpload session. Repo part index i is S3 part
    number i+1 (S3 numbers from 1); same-slot re-uploads are last-write-
    wins by keeping only the newest ETag per index."""

    def __init__(self, backend: S3Backend, bucket: str, key: str,
                 metadata: dict | None):
        self._b = backend
        self._bucket = bucket
        self._key = key
        resp = backend._s3.create_multipart_upload(
            Bucket=bucket, Key=key, Metadata=_encode_meta(metadata))
        self._upload_id = resp["UploadId"]
        self._lock = threading.Lock()
        self._etags: dict[int, str] = {}

    def put_part(self, index: int, data: bytes) -> None:
        index = int(index)
        if index < 0:
            raise ValueError(f"part index must be >= 0, got {index}")
        resp = self._b._s3.upload_part(
            Bucket=self._bucket, Key=self._key, UploadId=self._upload_id,
            PartNumber=index + 1, Body=bytes(data))
        with self._lock:
            self._etags[index] = resp["ETag"]

    def complete(self) -> ObjectMeta:
        with self._lock:
            parts = sorted(self._etags.items())
        self._b._s3.complete_multipart_upload(
            Bucket=self._bucket, Key=self._key, UploadId=self._upload_id,
            MultipartUpload={"Parts": [
                {"PartNumber": i + 1, "ETag": e} for i, e in parts]})
        return self._b.head(self._bucket, self._key)

    def abort(self) -> None:
        self._b._s3.abort_multipart_upload(
            Bucket=self._bucket, Key=self._key, UploadId=self._upload_id)


# ---------------------------------------------------------------------------
# GCS (gcsfs)
# ---------------------------------------------------------------------------


class GCSBackend(StoreBackend):
    """Google Cloud Storage via gcsfs.

    GCS has no part-numbered multipart API; the session stages each part
    as `<key>.__mp-<nonce>/part-<index:09d>` and `complete()` folds them
    into the destination with chained 32-way compose calls (GCS's
    compose limit), ascending by zero-padded index — the same assembly
    order as every other plane. `fs` may be injected for testing.
    """

    _NONCE = 0
    _NONCE_LOCK = threading.Lock()

    def __init__(self, *, project: str | None = None,
                 chunk_size: int = 4 << 20, fs=None):
        if fs is None:
            gcsfs = _require_dep("gcsfs", "GCSBackend", "gcsfs")
            fs = gcsfs.GCSFileSystem(project=project)  # pragma: no cover
        self._fs = fs
        self.chunk_size = int(chunk_size)

    @staticmethod
    def _path(bucket: str, key: str) -> str:  # pragma: no cover
        return f"{bucket}/{_check_key(key)}"

    def create_bucket(self, bucket: str) -> None:  # pragma: no cover
        try:
            self._fs.mkdir(bucket)
        except FileExistsError:
            pass

    def multipart(self, bucket: str, key: str,
                  metadata: dict | None = None) -> "_GcsMultipart":  # pragma: no cover
        return _GcsMultipart(self, bucket, _check_key(key), metadata)

    def get(self, bucket: str, key: str) -> bytes:  # pragma: no cover
        try:
            return self._fs.cat_file(self._path(bucket, key))
        except FileNotFoundError:
            raise ObjectNotFound(f"{bucket}/{key}") from None

    def get_range(self, bucket: str, key: str,
                  start: int, length: int) -> bytes:  # pragma: no cover
        if int(length) <= 0:
            return b""
        start = max(int(start), 0)
        try:
            size = self._fs.info(self._path(bucket, key))["size"]
            end = min(start + int(length), size)
            if start >= end:
                return b""
            return self._fs.cat_file(self._path(bucket, key),
                                     start=start, end=end)
        except FileNotFoundError:
            raise ObjectNotFound(f"{bucket}/{key}") from None

    def head(self, bucket: str, key: str) -> ObjectMeta:  # pragma: no cover
        try:
            info = self._fs.info(self._path(bucket, key))
        except FileNotFoundError:
            raise ObjectNotFound(f"{bucket}/{key}") from None
        raw = info.get("metadata") or {}
        return ObjectMeta(
            key=key, size=int(info["size"]),
            etag=str(info.get("crc32c") or info.get("etag") or ""),
            parts=int(raw.get(_PARTS_KEY, 1)), metadata=_decode_meta(raw))

    def list_objects(self, bucket: str,
                     prefix: str = "") -> list[ObjectMeta]:  # pragma: no cover
        try:
            paths = self._fs.find(f"{bucket}/{prefix}" if prefix else bucket)
        except FileNotFoundError:
            raise ObjectNotFound(bucket) from None
        keys = sorted(p.split("/", 1)[1] for p in paths)
        return [self.head(bucket, k) for k in keys]

    def delete(self, bucket: str, key: str) -> None:  # pragma: no cover
        try:
            self._fs.rm_file(self._path(bucket, key))
        except FileNotFoundError:
            raise ObjectNotFound(f"{bucket}/{key}") from None


class _GcsMultipart(MultipartUpload):  # pragma: no cover - needs network
    """Staged-object multipart for GCS (see GCSBackend docstring)."""

    def __init__(self, backend: GCSBackend, bucket: str, key: str,
                 metadata: dict | None):
        self._b = backend
        self._bucket = bucket
        self._key = key
        self._metadata = dict(metadata or {})
        with GCSBackend._NONCE_LOCK:
            nonce = GCSBackend._NONCE
            GCSBackend._NONCE += 1
        self._stage = f"{key}.__mp-{nonce}"
        self._lock = threading.Lock()
        self._indices: set[int] = set()

    def _part_path(self, index: int) -> str:
        return f"{self._bucket}/{self._stage}/part-{int(index):09d}"

    def put_part(self, index: int, data: bytes) -> None:
        index = int(index)
        if index < 0:
            raise ValueError(f"part index must be >= 0, got {index}")
        # GCS object writes are atomic: a same-index re-upload replaces
        # the staged object wholesale — last-write-wins for free.
        self._b._fs.pipe_file(self._part_path(index), bytes(data))
        with self._lock:
            self._indices.add(index)

    def complete(self) -> ObjectMeta:
        fs = self._b._fs
        with self._lock:
            parts = [self._part_path(i) for i in sorted(self._indices)]
        nparts = max(len(parts), 1)
        dest = f"{self._bucket}/{self._key}"
        # Chained compose: fold 32 at a time until one object remains.
        rank = 0
        while len(parts) > 32:
            folded = []
            for i in range(0, len(parts), 32):
                batch = parts[i:i + 32]
                if len(batch) == 1:
                    folded.append(batch[0])
                    continue
                out = f"{self._bucket}/{self._stage}/fold-{rank:04d}-{i:09d}"
                fs.merge(out, batch)
                folded.append(out)
            parts, rank = folded, rank + 1
        if len(parts) == 1:
            fs.mv(parts[0], dest)
        else:
            fs.merge(dest, parts)
        meta = dict(_encode_meta(self._metadata))
        meta[_PARTS_KEY] = str(nparts)
        fs.setxattrs(dest, metadata=meta)
        self.abort()  # sweep any remaining staged parts/folds
        return self._b.head(self._bucket, self._key)

    def abort(self) -> None:
        try:
            self._b._fs.rm(f"{self._bucket}/{self._stage}", recursive=True)
        except FileNotFoundError:
            pass


__all__ = ["S3Backend", "GCSBackend"]
