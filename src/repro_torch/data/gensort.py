"""gensort (paper §3.2) in torch: deterministic sort-benchmark records.

Port of src/repro/data/gensort.py; the records are bit-identical to the
reference's for the same (n, partitions, skew, seed):

  key     : uint32 = splitmix32(global_id)   (uniform — Indy category)
  id      : uint32 = global_id               (the "rank"/provenance)
  payload : (PAYLOAD_WORDS,) uint32, word j = splitmix32(id * PW + j + SALT)

PAYLOAD_WORDS = 23 words = 92 bytes, so header+payload = 100 bytes a
record, like the benchmark. The checksum is order-independent (sum mod
2^32, xor) over per-record hashes covering key, id and payload.

The uint32 arithmetic runs on int64 carriers in [0, 2^32) with every
product split so that nothing overflows int64; generation and checksums
run on the `device` asked for, so a card generates a wave in
milliseconds. `skewed_keys` stays host numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import u32

PAYLOAD_WORDS = 23  # 92 bytes; +8 header bytes = 100-byte records
_SALT = 0x9E3779B9
_MASK = u32.MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for an int64 carrier x in [0, 2^32), split at 16
    bits so no partial product reaches 2^63."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def splitmix32(x: torch.Tensor) -> torch.Tensor:
    """Fast avalanche hash (fmix32 finalizer): u32 tensor or int64 carrier
    in, int64 carrier out."""
    x = u32.widen(x)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def gen_keys(start: int, n: int, device="cuda"):
    """Generate records [start, start+n): returns (keys, ids) u32 tensors."""
    ids = torch.arange(start, start + n, dtype=torch.int64,
                       device=u32.resolve_device(device)) & _MASK
    return u32.narrow(splitmix32(ids)), u32.narrow(ids)


#: Deterministic skewed key variants (gensort's -s "skewed keyspace"
#: flag, adapted to the uint32 key): "hot", "zipf", "clustered", "dup" —
#: see the reference module for each distribution's shape.
SKEW_VARIANTS = ("hot", "zipf", "clustered", "dup")


def _splitmix32_np(x: np.ndarray) -> np.ndarray:
    # errstate: uint32 wraparound is the hash working as intended, but
    # numpy warns on overflow for 0-d (scalar) inputs.
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint32)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))


def skewed_keys(ids: np.ndarray, skew: str, seed: int = 0) -> np.ndarray:
    """Deterministic skewed key for each record id (host-side numpy).

    The key is a pure function of (id, skew, seed); ids and payloads are
    untouched, only the key distribution changes.
    """
    if skew not in SKEW_VARIANTS:
        raise ValueError(
            f"skew={skew!r}: must be one of {SKEW_VARIANTS} (or None "
            "for the uniform Indy keys)")
    ids = np.asarray(ids, dtype=np.uint32)
    mix = _splitmix32_np(np.uint32(seed) ^ np.uint32(0xDECAFBAD))
    u = _splitmix32_np(ids ^ mix)
    if skew == "hot":
        return np.where(u % np.uint32(8) < np.uint32(7),
                        u >> np.uint32(8), u)
    if skew == "zipf":
        h = _splitmix32_np(u ^ np.uint32(0x5BD1E995))
        return u >> (h % np.uint32(24)).astype(np.uint32)
    if skew == "clustered":
        prefs = _splitmix32_np(
            np.uint32(mix) + np.arange(4, dtype=np.uint32)) >> np.uint32(24)
        sel = prefs[(u % np.uint32(4)).astype(np.int64)]
        return (sel.astype(np.uint32) << np.uint32(24)) | (
            _splitmix32_np(u) >> np.uint32(8))
    # "dup": one seed-derived hot key on a fixed id stride.
    hot = _splitmix32_np(mix ^ np.uint32(0x27220A95))
    return np.where(ids % np.uint32(4) == 0, hot, u)


def gen_payload(ids: torch.Tensor, words: int = PAYLOAD_WORDS) -> torch.Tensor:
    """(n, words) u32 payload rows, derivable from ids alone."""
    base = _mul32(u32.widen(ids), words)[:, None]
    j = torch.arange(words, dtype=torch.int64, device=ids.device)[None, :]
    return u32.narrow(splitmix32((base + j + _SALT) & _MASK))


def payload_hash(payload: torch.Tensor) -> torch.Tensor:
    """(n,) int64-carrier per-record hash of the payload words."""
    # Position-sensitive fold so word swaps are detected.
    j = torch.arange(payload.shape[-1], dtype=torch.int64,
                     device=payload.device)[None, :]
    return splitmix32((u32.widen(payload) + j) & _MASK).sum(dim=-1) & _MASK


def record_hashes(keys, ids, payload=None) -> torch.Tensor:
    h = splitmix32(u32.widen(keys) ^ splitmix32(ids))
    if payload is not None:
        h = splitmix32(h ^ payload_hash(payload))
    return h


def _xor_reduce(h: torch.Tensor) -> int:
    """XOR of every element of a 1-D int64 tensor (pairwise halving)."""
    while h.numel() > 1:
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        h = h[0::2] ^ h[1::2]
    return int(h[0]) if h.numel() else 0


def checksum(keys, ids, payload=None) -> tuple[int, int]:
    """Order-independent (sum, xor) checksum over record hashes."""
    h = record_hashes(keys, ids, payload)
    return int(h.sum()) & _MASK, _xor_reduce(h)


def combine_checksums(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    """Fold two partial (sum, xor) checksums — both ops are associative
    and order-independent, so streamed generation/validation can checksum
    the dataset one batch at a time."""
    return (int(a[0]) + int(b[0])) & 0xFFFFFFFF, int(a[1]) ^ int(b[1])


def write_to_store(
    store,
    bucket: str,
    prefix: str,
    total_records: int,
    records_per_partition: int,
    payload_words: int = PAYLOAD_WORDS,
    *,
    start_id: int = 0,
    skew: str | None = None,
    skew_seed: int = 0,
    device="cuda",
) -> tuple[tuple[int, int], int]:
    """Generate the benchmark input directly into an object store.

    The paper's `gensort -b{offset}` step: partition p holds records
    [p * rpp, (p+1) * rpp), one io/records-encoded object per partition.
    Records are generated on `device` and encoded on the host. Returns
    the aggregate input checksum and the number of partitions written.
    """
    from repro_torch.io import records as rec

    assert total_records % records_per_partition == 0
    if skew is not None and skew not in SKEW_VARIANTS:
        raise ValueError(
            f"skew={skew!r}: must be one of {SKEW_VARIANTS} or None")
    dev = u32.resolve_device(device)
    num_parts = total_records // records_per_partition
    # Overwrite semantics: the prefix holds exactly this dataset afterwards.
    for meta in store.list_objects(bucket, prefix):
        store.delete(bucket, meta.key)
    ck = (0, 0)
    for p in range(num_parts):
        keys, ids = gen_keys(start_id + p * records_per_partition,
                             records_per_partition, dev)
        if skew is not None:
            keys = u32.from_numpy(
                skewed_keys(u32.to_numpy(ids), skew, skew_seed), dev)
        payload = gen_payload(ids, payload_words) if payload_words else None
        ck = combine_checksums(ck, checksum(keys, ids, payload))
        data = rec.encode_records(
            u32.to_numpy(keys), u32.to_numpy(ids),
            None if payload is None else u32.to_numpy(payload),
        )
        store.put(bucket, f"{prefix}part-{p:05d}", data,
                  metadata={"records": records_per_partition})
    return ck, num_parts
