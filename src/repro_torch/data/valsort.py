"""valsort (paper §3.2): validate ordering + integrity.

Port of src/repro/data/valsort.py, with the same three gates over the
sort's output:
  1. each segment is lex-sorted (ascending by key, tie-broken by id);
  2. segment boundaries are non-decreasing (worker w's max <= w+1's min),
     which with (1) gives total ordering;
  3. the order-independent checksum of (key, id[, payload]) matches the
     input's — no record lost, duplicated, or corrupted.

The ordering gates run in host numpy; the checksum runs on `device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import gensort
from repro_torch.kernels import u32


@dataclasses.dataclass
class ValsortReport:
    total_records: int
    sorted_within: bool
    sorted_across: bool
    checksum_match: bool
    input_checksum: tuple[int, int]
    output_checksum: tuple[int, int]

    @property
    def ok(self) -> bool:
        return self.sorted_within and self.sorted_across and self.checksum_match


def _checksum_np(keys, ids, payload, device) -> tuple[int, int]:
    dev = u32.resolve_device(device)
    return gensort.checksum(
        u32.from_numpy(keys, dev), u32.from_numpy(ids, dev),
        None if payload is None else u32.from_numpy(payload, dev))


def validate(
    segments_keys: list[np.ndarray],
    segments_ids: list[np.ndarray],
    input_checksum: tuple[int, int],
    segments_payload: list[np.ndarray] | None = None,
    *,
    device="cuda",
) -> ValsortReport:
    """segments_*: per-worker valid output slices (numpy uint32), in
    worker-range order."""
    sorted_within = True
    sorted_across = True
    prev_max = None
    for k, i in zip(segments_keys, segments_ids):
        if len(k) == 0:
            continue
        k64 = k.astype(np.uint64) << np.uint64(32) | i.astype(np.uint64)
        # NB: not np.diff >= 0 — unsigned subtraction wraps.
        if not (k64[1:] >= k64[:-1]).all():
            sorted_within = False
        if prev_max is not None and k64[0] < prev_max:
            sorted_across = False
        prev_max = k64[-1]

    all_k = np.concatenate([np.asarray(s) for s in segments_keys])
    all_i = np.concatenate([np.asarray(s) for s in segments_ids])
    all_p = (
        np.concatenate([np.asarray(s) for s in segments_payload])
        if segments_payload is not None
        else None
    )
    out_ck = _checksum_np(all_k, all_i, all_p, device)
    return ValsortReport(
        total_records=int(all_k.shape[0]),
        sorted_within=sorted_within,
        sorted_across=sorted_across,
        checksum_match=out_ck == tuple(int(c) for c in input_checksum),
        input_checksum=tuple(int(c) for c in input_checksum),
        output_checksum=out_ck,
    )


def validate_from_store(
    store,
    bucket: str,
    prefix: str,
    input_checksum: tuple[int, int],
    *,
    chunk_records: int = 1 << 13,
    device="cuda",
) -> ValsortReport:
    """Out-of-core valsort: stream output partitions from the object store
    in `chunk_records` ranged GETs, check ordering within partitions,
    across chunk boundaries and across partition boundaries, and fold the
    order-independent checksum incrementally against the input's."""
    from repro_torch.io import records as rec

    objs = store.list_objects(bucket, prefix)
    sorted_within = True
    sorted_across = True
    total = 0
    out_ck = (0, 0)
    prev_last = None  # (key<<32 | id) of the previous record seen

    for meta in objs:
        n, pw = rec.decode_header(store.get_range(bucket, meta.key, 0, rec.HEADER_BYTES))
        first_of_partition = True
        for lo in range(0, n, chunk_records):
            cnt = min(chunk_records, n - lo)
            start, length = rec.body_range(lo, cnt, pw)
            k, i, p = rec.decode_body(store.get_range(bucket, meta.key, start, length), pw)
            k64 = k.astype(np.uint64) << np.uint64(32) | i.astype(np.uint64)
            # Direct comparison, not np.diff >= 0: unsigned diff wraps.
            if not (k64[1:] >= k64[:-1]).all():
                sorted_within = False
            if prev_last is not None and len(k64) and k64[0] < prev_last:
                if first_of_partition:
                    sorted_across = False
                else:
                    sorted_within = False
            if len(k64):
                prev_last = k64[-1]
                first_of_partition = False
            out_ck = gensort.combine_checksums(
                out_ck, _checksum_np(k, i, p, device))
            total += cnt
    return ValsortReport(
        total_records=total,
        sorted_within=sorted_within,
        sorted_across=sorted_across,
        checksum_match=out_ck == tuple(int(c) for c in input_checksum),
        input_checksum=tuple(int(c) for c in input_checksum),
        output_checksum=out_ck,
    )


def slice_segments(sorted_keys, sorted_ids, counts, payload=None):
    """Split the flat global output of distributed_sort (numpy arrays or
    u32 tensors) into valid numpy segments."""
    def host(a):
        return u32.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)

    sorted_keys = host(sorted_keys)
    sorted_ids = host(sorted_ids)
    counts = np.asarray(counts.cpu() if isinstance(counts, torch.Tensor)
                        else counts)
    w = counts.shape[0]
    seg = sorted_keys.shape[0] // w
    ks, ids, ps = [], [], []
    for d in range(w):
        lo, n = d * seg, int(counts[d])
        ks.append(sorted_keys[lo : lo + n])
        ids.append(sorted_ids[lo : lo + n])
        if payload is not None:
            ps.append(host(payload)[lo : lo + n])
    return (ks, ids, ps) if payload is not None else (ks, ids, None)
