"""Record-block codec: (key, id, payload) arrays <-> object bytes.

The sort benchmark's unit of storage is the 100-byte record (§2.2): a
10-byte key plus 90-byte payload, laid out *interleaved* so that any
contiguous record range of an object maps to one contiguous byte range —
which is what lets the reduce pass fetch exactly its reducer's slice of a
spilled run with a single S3 ranged GET (core/external_sort.py).

Our record (DESIGN.md §2 key-width adaptation, as in data/gensort.py):

  row = [key: u32][id: u32][payload: u32 x payload_words]   little-endian

An encoded object is a 16-byte header (magic, version, n_records,
payload_words) followed by n_records interleaved rows. `body_range`
computes the byte range of a record slice so callers never re-derive the
layout; `decode_body` parses a headerless ranged-GET response.
"""
from __future__ import annotations

import numpy as np

MAGIC = 0x58535254  # "XSRT"
VERSION = 1
HEADER_BYTES = 16


def record_bytes(payload_words: int) -> int:
    """Bytes per interleaved record row."""
    return 4 * (2 + int(payload_words))


def encode_header(n_records: int, payload_words: int) -> bytes:
    """The HEADER_BYTES prefix of an encoded object. Split out from
    encode_records so a streaming writer that knows its final record
    count up front (the reduce merge does — it's the sum of its run-slice
    lengths) can emit the header first and append body chunks as they are
    merged, never materializing the object."""
    return np.array([MAGIC, VERSION, int(n_records), int(payload_words)],
                    dtype="<u4").tobytes()


def encode_body(keys, ids, payload=None) -> bytes:
    """Interleaved rows only (no header) — one streamable body chunk."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    n = keys.shape[0]
    assert ids.shape == (n,)
    pw = 0 if payload is None else int(payload.shape[-1])
    rows = np.empty((n, 2 + pw), dtype="<u4")
    rows[:, 0] = keys
    rows[:, 1] = ids
    if pw:
        assert payload.shape == (n, pw)
        rows[:, 2:] = np.asarray(payload, dtype=np.uint32)
    return rows.tobytes()


def encode_records(keys, ids, payload=None) -> bytes:
    """Pack records into one object. keys/ids (n,) u32; payload (n, pw) u32
    or None (header-only records, pw=0)."""
    pw = 0 if payload is None else int(payload.shape[-1])
    return encode_header(len(keys), pw) + encode_body(keys, ids, payload)


def decode_header(data: bytes) -> tuple[int, int]:
    """(n_records, payload_words) from the first HEADER_BYTES of an object."""
    magic, version, n, pw = np.frombuffer(data[:HEADER_BYTES], dtype="<u4")
    if magic != MAGIC or version != VERSION:
        # ValueError, not assert: the format gate must survive python -O.
        raise ValueError("not an XSRT record object")
    return int(n), int(pw)


def decode_records(data: bytes):
    """Inverse of encode_records: (keys, ids, payload|None)."""
    n, pw = decode_header(data)
    body = data[HEADER_BYTES : HEADER_BYTES + n * record_bytes(pw)]
    return decode_body(body, pw)


def decode_body(body: bytes, payload_words: int):
    """Parse headerless interleaved rows (a ranged-GET response)."""
    pw = int(payload_words)
    rb = record_bytes(pw)
    assert len(body) % rb == 0, (len(body), rb)
    rows = np.frombuffer(body, dtype="<u4").reshape(-1, 2 + pw)
    keys = rows[:, 0].astype(np.uint32)
    ids = rows[:, 1].astype(np.uint32)
    payload = rows[:, 2:].astype(np.uint32) if pw else None
    return keys, ids, payload


def body_range(start_record: int, n_records: int, payload_words: int):
    """(byte_offset, byte_length) of records [start, start+n) within an
    encoded object — the ranged-GET window for a run slice."""
    rb = record_bytes(payload_words)
    return HEADER_BYTES + int(start_record) * rb, int(n_records) * rb


# ---------------------------------------------------------------------------
# Zero-copy wave assembly: decode chunk streams straight into one buffer
# ---------------------------------------------------------------------------


def alloc_rows(n_records: int, payload_words: int) -> np.ndarray:
    """One preallocated interleaved-row buffer for `n_records` records —
    the target StreamDecoder fills and split_rows views into."""
    return np.empty((int(n_records), 2 + int(payload_words)), dtype="<u4")


def split_rows(rows: np.ndarray):
    """(keys, ids, payload|None) *views* into an interleaved rows buffer —
    no copy; the row storage stays the single owner of the bytes."""
    pw = rows.shape[1] - 2
    return rows[:, 0], rows[:, 1], (rows[:, 2:] if pw else None)


class StreamDecoder:
    """Decode one encoded object's chunk stream straight into a rows buffer.

    The zero-copy map download path (core/external_sort.py): instead of
    `b"".join(chunks)` + decode + `np.concatenate` across objects — three
    full copies of every wave byte — each ranged-GET chunk is copied once,
    directly into its final position in a preallocated `alloc_rows` buffer
    at `start_record`. Works for any chunking: record and header
    boundaries may fall anywhere inside or across chunks.

    Feed chunks in object-byte order (`feed`), then `finish()` — which
    validates the object header (magic/version, record count against the
    records actually written, payload width against the buffer's) and
    returns the record count.
    """

    def __init__(self, rows: np.ndarray, start_record: int = 0,
                 *, what: str = "object"):
        pw = rows.shape[1] - 2
        self._rb = record_bytes(pw)
        self._pw = pw
        self._what = what
        self._header = bytearray()
        if not rows.flags.c_contiguous:
            raise ValueError("rows buffer must be C-contiguous")
        self._dest = memoryview(rows).cast("B")
        self._off = int(start_record) * self._rb
        self._start = self._off

    def feed(self, chunk: bytes) -> None:
        view = memoryview(chunk)
        if len(self._header) < HEADER_BYTES:  # header may span chunks
            take = min(HEADER_BYTES - len(self._header), len(view))
            self._header += view[:take]
            view = view[take:]
        if len(view):
            end = self._off + len(view)
            if end > len(self._dest):
                raise ValueError(
                    f"{self._what}: body overflows the rows buffer "
                    f"(byte {end} > {len(self._dest)})")
            self._dest[self._off:end] = view
            self._off = end

    def finish(self) -> int:
        if len(self._header) < HEADER_BYTES:
            raise ValueError(f"{self._what}: truncated header "
                             f"({len(self._header)} bytes)")
        n, pw = decode_header(bytes(self._header))
        written, want = self._off - self._start, n * self._rb
        if pw != self._pw:
            raise ValueError(f"{self._what}: payload_words={pw}, "
                             f"buffer expects {self._pw}")
        if written != want:
            raise ValueError(f"{self._what}: body is {written} bytes, "
                             f"header promises {want}")
        return n
