"""The benchmark's records with the Sort Benchmark's whole 10-byte key,
and the plain reference of their order.

A record is the rules' 100 bytes, as the port holds them (u32 words):

  key word     key bytes 0-3, big-endian: the high half of z(id)
  id           record i has id i (4 value bytes)
  payload[0]   key bytes 4-7, big-endian: the low half of z(id)
  payload[1]   key bytes 8-9 in the high half (the top 16 bits of a
               seeded fmix32 hash of the id), 2 value bytes in the low
  payload[2:]  21 value words

z(i) is output i of SplitMix64 started from a 64-bit mix of the seed:
the key's first 8 bytes are a random function of (id, seed), so the key
words repeat as random 32-bit words do (N^2 / 2^33 equal pairs in all,
about 2^19 at 2^26 records, whatever the seed), and the workers' equal
ranges of the key word split the records evenly. `gen.keys_t`, the
4-byte cells' key, is not used here: it is fmix(i ^ m1) ^ fmix(i ^ m2'),
so i and i ^ d share their key word for d = m1 ^ m2', and where the
seed makes d small most records of a data set pair up.

The value words are `gen.payload_t`'s, so nothing of `gen` changes.
gensort's generator is not used. Torch (`*_t`, int64 carriers, any
device; the 64-bit products wrap) and numpy (`*_np`, uint64) give the
same bits.

The reference orders records by the key's ten bytes as unsigned bytes,
left to right, then by id, as valsort does, splits the order at the
workers' equal ranges of the key word, and counts the output's records
whose key word, id or any payload word differ from it.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import gen

PAYLOAD_WORDS = gen.PAYLOAD_WORDS
KEY_SHAPES = ("uniform",)
_M64 = (1 << 64) - 1
GAMMA = 0x9E3779B97F4A7C15  # SplitMix64's increment
MIX = (0xBF58476D1CE4E5B9, 0x94D049BB133111EB)  # its two multipliers


def _signed(c: int) -> int:
    return c - (1 << 64) if c >> 63 else c


def seed_state(seed: int) -> tuple[int, int]:
    """(SplitMix64's start, as a u64; a 32-bit mix for key bytes 8-9)
    of the seed, apart from `gen.seed_words`' three."""
    _, _, m3 = gen.seed_words(seed)
    a = int(gen._fmix_np(np.uint32(m3 ^ 0x2545F491)))
    b = int(gen._fmix_np(np.uint32(a ^ 0x9E3779B9)))
    c = int(gen._fmix_np(np.uint32(b ^ 0x85EBCA6B)))
    return (a << 32) | b, c


def _check(shape: str) -> None:
    if shape not in KEY_SHAPES:
        raise ValueError(f"key shape {shape!r}: one of {KEY_SHAPES}")


# --- torch (int64 carriers in [0, 2^32)) ---------------------------------


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def key_parts_t(ids: torch.Tensor, seed: int, shape: str = "uniform"):
    """(key word, key bytes 4-7, key bytes 8-9) of int64 ids: two u32
    carriers and a 16-bit number."""
    _check(shape)
    s, c = seed_state(seed)
    z = _signed(s) + (ids + 1) * _signed(GAMMA)
    z = (z ^ _srl(z, 30)) * _signed(MIX[0])
    z = (z ^ _srl(z, 27)) * _signed(MIX[1])
    z = z ^ _srl(z, 31)
    return _srl(z, 32), z & gen.MASK, gen._fmix_t(ids ^ c) >> 16


def tail48_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """Key bytes 4-9 of int64 ids as one 48-bit number."""
    _, w0, lo = key_parts_t(ids, seed)
    return (w0 << 16) | lo


def payload_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """(n, 23) int32 payload rows of int64 ids, key bytes 4-9 in front."""
    rows = gen.payload_t(ids, seed)
    _, w0, lo = key_parts_t(ids, seed)
    rows[:, 0] = gen.to_u32(w0)
    rows[:, 1] = gen.to_u32((lo << 16) | (gen.widen(rows[:, 1]) & 0xFFFF))
    return rows


def records_t(start: int, n: int, seed: int, shape: str, device,
              chunk: int = 1 << 21):
    """Records [start, start + n) as port u32 tensors on `device`: key
    words (n,), ids (n,), payload (n, 23), made in chunks."""
    keys = torch.empty(n, dtype=torch.int32, device=device)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    pay = torch.empty((n, PAYLOAD_WORDS), dtype=torch.int32, device=device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        i64 = torch.arange(start + a, start + b, dtype=torch.int64,
                           device=device)
        keys[a:b] = gen.to_u32(key_parts_t(i64, seed, shape)[0])
        ids[a:b] = gen.to_u32(i64)
        pay[a:b] = payload_t(i64, seed)
    return keys, ids, pay


def lex_order(n: int, seed: int, shape: str, device):
    """The seed's records 0..n-1 in the rules' order: (key words, ids)
    as int64 carriers, sorted by (key word, key bytes 4-9, id). Ids are
    the records' positions, so the two stable sorts start from id
    order."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    order = torch.sort(tail48_t(ids, seed), stable=True).indices
    words = key_parts_t(order, seed, shape)[0]
    step = torch.sort(words, stable=True).indices
    return words[step], order[step]


# --- numpy (the same bits) -----------------------------------------------


def key_parts_np(ids: np.ndarray, seed: int, shape: str = "uniform"):
    """key_parts_t's bits from uint32 ids, as uint32 arrays."""
    _check(shape)
    s, c = seed_state(seed)
    ids = np.asarray(ids, dtype=np.uint32)
    with np.errstate(over="ignore"):
        z = np.uint64(s) + (ids.astype(np.uint64) + np.uint64(1)) \
            * np.uint64(GAMMA)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(MIX[0])
        z = (z ^ (z >> np.uint64(27))) * np.uint64(MIX[1])
    z ^= z >> np.uint64(31)
    return ((z >> np.uint64(32)).astype(np.uint32), z.astype(np.uint32),
            gen._fmix_np(ids ^ np.uint32(c)) >> np.uint32(16))


def payload_np(ids: np.ndarray, seed: int) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint32)
    rows = gen.payload_np(ids, seed)
    _, w0, lo = key_parts_np(ids, seed)
    rows[:, 0] = w0
    rows[:, 1] = (lo << np.uint32(16)) | (rows[:, 1] & np.uint32(0xFFFF))
    return rows


# --- the comparison -----------------------------------------------------


def mismatched_rows(keys, ids, payload, ref_keys, ref_ids, seed: int,
                    chunk: int = 1 << 21) -> int:
    """Rows whose key word, id or any payload word differ from the
    reference's, the payload made again from the reference's ids."""
    dev = ref_keys.device
    bad = 0
    for a in range(0, ref_keys.shape[0], chunk):
        b = min(a + chunk, ref_keys.shape[0])
        rk, ri = ref_keys[a:b], ref_ids[a:b]
        wrong = gen.widen(keys[a:b].to(dev)) != rk
        wrong |= gen.widen(ids[a:b].to(dev)) != ri
        wrong |= (payload[a:b].to(dev) != payload_t(ri, seed)).any(dim=-1)
        bad += int(wrong.sum())
    return bad


def compare_segments(segments, ref_keys, ref_ids, starts, seed: int) -> int:
    """Mismatches of the program's segments (keys, ids, payload, count)
    against the reference's ranges; a missing or extra record counts as
    one mismatch, and so does each wrong row."""
    bad = 0
    for j, (keys, ids, payload, count) in enumerate(segments):
        lo, hi = int(starts[j]), int(starts[j + 1])
        m = min(int(count), hi - lo)
        bad += abs(int(count) - (hi - lo))
        bad += mismatched_rows(keys[:m], ids[:m], payload[:m],
                               ref_keys[lo:lo + m], ref_ids[lo:lo + m], seed)
    return bad
