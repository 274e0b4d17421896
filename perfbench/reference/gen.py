"""The benchmark's input generator: 100-byte records drawn from a seed.

A record is the port's layout: a 4-byte key, a 4-byte id and 23 payload
words (92 bytes). Record i of a data set has id i (gensort's sequential
ids, which the port's payload modes rely on: id // (N/W) is the worker
that holds the record). The key and payload are pure functions of (id,
seed), so any slice of the data set can be made again on its own, on
the card or the host, and the reference makes the same records the
program was given.

Key shapes (frozen here; the program's own generator is not used):

  uniform : two seeded fmix32 hashes of the id, xor-ed, so 32-bit keys
            repeat as random keys do (about N^2 / 2^33 equal pairs).

Arithmetic is uint32 on int64 carriers in torch (`*_t`, any device) and
uint32 in numpy (`*_np`); both give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

PAYLOAD_WORDS = 23
RECORD_BYTES = 4 * (2 + PAYLOAD_WORDS)
KEY_SHAPES = ("uniform",)
MASK = 0xFFFFFFFF
_SIGN = 1 << 31


def _fmix_np(x):
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint32)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
        x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
        return x ^ (x >> np.uint32(16))


def seed_words(seed: int) -> tuple[int, int, int]:
    """Three 32-bit mixes of a seed of up to 64 bits."""
    seed = int(seed) & ((1 << 64) - 1)
    lo, hi = seed & MASK, seed >> 32
    a = int(_fmix_np(np.uint32(lo) ^ _fmix_np(np.uint32(hi ^ 0x68E31DA4))))
    return (a, int(_fmix_np(np.uint32(a ^ 0x1B873593))),
            int(_fmix_np(np.uint32(a ^ 0xCC9E2D51))))


# --- torch (int64 carriers in [0, 2^32)) ---------------------------------


def _mul_t(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _fmix_t(x):
    x = _mul_t(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul_t(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 carrier -> int32 bit storage (the port's u32 tensors)."""
    return ((x ^ _SIGN) - _SIGN).to(torch.int32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit storage -> int64 carrier in [0, 2^32)."""
    return t.to(torch.int64) & MASK


def keys_t(ids: torch.Tensor, seed: int, shape: str) -> torch.Tensor:
    """int64 carrier keys of int64 ids."""
    m1, m2, _ = seed_words(seed)
    u = _fmix_t(ids ^ m1) ^ _fmix_t(ids ^ m2 ^ 0x5BD1E995)
    if shape == "uniform":
        return u
    raise ValueError(f"key shape {shape!r}: one of {KEY_SHAPES}")


def payload_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """(n, 23) int32 payload rows of int64 ids."""
    _, _, m3 = seed_words(seed)
    j = torch.arange(PAYLOAD_WORDS, dtype=torch.int64, device=ids.device)
    base = _mul_t(ids, PAYLOAD_WORDS)[:, None]
    return to_u32(_fmix_t(((base + j) & MASK) ^ m3))


def headers_t(start: int, n: int, seed: int, shape: str, device):
    """Keys and ids of records [start, start + n) as u32 tensors."""
    i64 = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return to_u32(keys_t(i64, seed, shape)), to_u32(i64)


def records_t(start: int, n: int, seed: int, shape: str, device,
              chunk: int = 1 << 21):
    """Records [start, start + n) as port u32 tensors on `device`: keys
    (n,), ids (n,), payload (n, 23), made in chunks of `chunk` records so
    the int64 temporaries stay small."""
    keys = torch.empty(n, dtype=torch.int32, device=device)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    pay = torch.empty((n, PAYLOAD_WORDS), dtype=torch.int32, device=device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        i64 = torch.arange(start + a, start + b, dtype=torch.int64,
                           device=device)
        keys[a:b] = to_u32(keys_t(i64, seed, shape))
        ids[a:b] = to_u32(i64)
        pay[a:b] = payload_t(i64, seed)
    return keys, ids, pay


# --- numpy (the same bits, for host-side checks and tests) ---------------


def keys_np(ids: np.ndarray, seed: int, shape: str) -> np.ndarray:
    m1, m2, _ = seed_words(seed)
    ids = np.asarray(ids, dtype=np.uint32)
    u = _fmix_np(ids ^ np.uint32(m1)) ^ _fmix_np(
        ids ^ np.uint32(m2 ^ 0x5BD1E995))
    if shape == "uniform":
        return u
    raise ValueError(f"key shape {shape!r}: one of {KEY_SHAPES}")


def payload_np(ids: np.ndarray, seed: int) -> np.ndarray:
    _, _, m3 = seed_words(seed)
    ids = np.asarray(ids, dtype=np.uint32)
    with np.errstate(over="ignore"):
        base = ids * np.uint32(PAYLOAD_WORDS)
        x = base[:, None] + np.arange(PAYLOAD_WORDS, dtype=np.uint32)
    return _fmix_np(x ^ np.uint32(m3))
