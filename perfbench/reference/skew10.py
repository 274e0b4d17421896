"""The Daytona cell's records: the Sort Benchmark's 10-byte key under
CloudSort's skew, and the plain reference of their whole order.

The unskewed key K is key10's: 80 bits, bytes 0-7 output id of
SplitMix64 started from a mix of the seed, bytes 8-9 a seeded fmix32
hash of the id (reference/key10.py, whose parts are reused). The skew is
the port's "zipf" shape (`u >> (h mod 24)`) on the whole key:

  K' = K >> s,  s = fmix32(id ^ a mix of the seed) mod 24

so the key's magnitude is log-uniform (density about 1/key): three
quarters of the records fall in the lowest 2^-6 of the key words, most
lie in runs of equal key words (two thirds at 2^26 records), and an
equal split of the key word into 8 ranges sends 91% to the first. A
record is laid out as key10's (the port's u32 words):

  key word     key bytes 0-3 of K', big-endian: K >> (48 + s)
  id           record i has id i (4 value bytes)
  payload[0]   key bytes 4-7 of K'
  payload[1]   key bytes 8-9 of K' in the high half, 2 value bytes in
               the low
  payload[2:]  21 value words (`gen.payload_t`'s)

Torch (`*_t`, int64 carriers, any device) and numpy (`*_np`, uint64)
give the same bits. gensort's own -s generator is not in the
repository and is not used.

The reference sorts all records by the ten key bytes as unsigned bytes,
left to right, then by id, as valsort does, with no split at worker
ranges: the program's splitters are its own, so its W workers' valid
prefixes, concatenated in worker order, must be that whole order. It
counts the records whose key word, id or any payload word differ, and
each record missing or extra.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import gen, key10

PAYLOAD_WORDS = gen.PAYLOAD_WORDS
SHIFTS = 24  # s in [0, 24): the key keeps at least 56 of its 80 bits
SHIFT_MIX = 0x27D4EB2F  # apart from key10's mix for key bytes 8-9


def shift_seed(seed: int) -> int:
    """The 32-bit mix of the seed that draws each record's shift."""
    return int(gen._fmix_np(np.uint32(key10.seed_state(seed)[1]
                                      ^ SHIFT_MIX)))


# --- torch (int64 carriers) ----------------------------------------------


def shifts_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    return gen._fmix_t(ids ^ shift_seed(seed)) % SHIFTS


def key_parts_t(ids: torch.Tensor, seed: int):
    """(key word, key bytes 4-7, key bytes 8-9) of K' for int64 ids: two
    u32 carriers and a 16-bit number."""
    hi, lo, tail = key10.key_parts_t(ids, seed)
    s = shifts_t(ids, seed)
    low_bits = hi & ((1 << s) - 1)  # the bits of word 0 that move down
    w0 = (lo >> s) | (low_bits << (32 - s))
    return hi >> s, w0, (((lo << 16) | tail) >> s) & 0xFFFF


def tail48_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """Key bytes 4-9 of K' as one 48-bit number."""
    _, w0, tail = key_parts_t(ids, seed)
    return (w0 << 16) | tail


def payload_t(ids: torch.Tensor, seed: int) -> torch.Tensor:
    """(n, 23) int32 payload rows of int64 ids, key bytes 4-9 in front."""
    rows = gen.payload_t(ids, seed)
    _, w0, tail = key_parts_t(ids, seed)
    rows[:, 0] = gen.to_u32(w0)
    rows[:, 1] = gen.to_u32((tail << 16) | (gen.widen(rows[:, 1]) & 0xFFFF))
    return rows


def records_t(start: int, n: int, seed: int, device, chunk: int = 1 << 21):
    """Records [start, start + n) as port u32 tensors on `device`: key
    words (n,), ids (n,), payload (n, 23), made in chunks."""
    keys = torch.empty(n, dtype=torch.int32, device=device)
    ids = torch.empty(n, dtype=torch.int32, device=device)
    pay = torch.empty((n, PAYLOAD_WORDS), dtype=torch.int32, device=device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        i64 = torch.arange(start + a, start + b, dtype=torch.int64,
                           device=device)
        keys[a:b] = gen.to_u32(key_parts_t(i64, seed)[0])
        ids[a:b] = gen.to_u32(i64)
        pay[a:b] = payload_t(i64, seed)
    return keys, ids, pay


def lex_order(n: int, seed: int, device):
    """The seed's records 0..n-1 in the rules' order: (key words, ids)
    as int64 carriers, sorted by (key word, key bytes 4-9, id). Ids are
    the records' positions, so the two stable sorts start from id
    order."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    order = torch.sort(tail48_t(ids, seed), stable=True).indices
    words = key_parts_t(order, seed)[0]
    step = torch.sort(words, stable=True).indices
    return words[step], order[step]


# --- numpy (the same bits) -----------------------------------------------


def key_parts_np(ids: np.ndarray, seed: int):
    """key_parts_t's bits from uint32 ids, as uint32 arrays."""
    ids = np.asarray(ids, dtype=np.uint32)
    hi, lo, tail = (a.astype(np.uint64) for a in key10.key_parts_np(ids,
                                                                     seed))
    s = (gen._fmix_np(ids ^ np.uint32(shift_seed(seed)))
         % np.uint32(SHIFTS)).astype(np.uint64)
    one = np.uint64(1)
    w0 = (lo >> s) | ((hi & ((one << s) - one)) << (np.uint64(32) - s))
    t = (((lo << np.uint64(16)) | tail) >> s) & np.uint64(0xFFFF)
    return ((hi >> s).astype(np.uint32), (w0 & np.uint64(gen.MASK)).astype(
        np.uint32), t.astype(np.uint32))


def payload_np(ids: np.ndarray, seed: int) -> np.ndarray:
    ids = np.asarray(ids, dtype=np.uint32)
    rows = gen.payload_np(ids, seed)
    _, w0, tail = key_parts_np(ids, seed)
    rows[:, 0] = w0
    rows[:, 1] = (tail << np.uint32(16)) | (rows[:, 1] & np.uint32(0xFFFF))
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


def compare_whole(segments, ref_keys, ref_ids, seed: int) -> int:
    """Mismatches of the program's segments (keys, ids, payload, count),
    their valid prefixes concatenated in order, against the reference's
    whole order: each wrong row counts once, and so does each record
    missing or extra, and each that a count claims past its segment."""
    n = ref_keys.shape[0]
    bad, lo = 0, 0
    for keys, ids, payload, count in segments:
        held = min(int(count), keys.shape[0])
        m = max(0, min(held, n - lo))
        bad += mismatched_rows(keys[:m], ids[:m], payload[:m],
                               ref_keys[lo:lo + m], ref_ids[lo:lo + m], seed)
        bad += int(count) - held
        lo += int(count)
    return bad + abs(lo - n)
