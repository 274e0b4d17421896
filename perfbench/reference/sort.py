"""The plain reference: what a sort of the benchmark's records must give.

Plain torch (any device), independent of the program: it imports no
module of the port. The reference orders records by (key, id) as
unsigned integers, splits the order into the workers' equal key ranges,
and counts the records whose key, id or payload differ from the
program's output.
Expected payload rows are made again from the ids and the seed, so
nothing the program produced feeds the expectation.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import gen

KEY_SPACE = 1 << 32


def lex_order(keys: torch.Tensor, ids: torch.Tensor, *,
              key_bits: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted keys, sorted ids) as int64 carriers, ordered by (key, id).
    `key_bits` < 32 orders by the key's top bits alone (ties by id): the
    control's sort, which breaks the configuration's ordering guarantee
    as a sort at a lower key precision would."""
    k, i = gen.widen(keys), gen.widen(ids)
    top = k >> (32 - key_bits)
    _, order = torch.sort((top - (1 << 31)) * KEY_SPACE + i)
    return k[order], i[order]


def equal_bounds(parts: int) -> np.ndarray:
    """(parts-1,) internal boundaries of an equal split of [0, 2^32)."""
    j = np.arange(1, parts, dtype=np.uint64)
    return ((j * np.uint64(KEY_SPACE)) // np.uint64(parts)).astype(np.int64)


def range_starts(sorted_keys: torch.Tensor, bounds: np.ndarray):
    """Start of each of the len(bounds)+1 ranges [b_{j-1}, b_j) in the
    sorted keys, and the end: (parts + 1,) int64 on the host."""
    b = torch.as_tensor(bounds, dtype=torch.int64,
                        device=sorted_keys.device)
    inner = torch.searchsorted(sorted_keys, b).cpu().numpy()
    return np.concatenate(([0], inner, [sorted_keys.shape[0]]))


def mismatched_rows(keys: torch.Tensor, ids: torch.Tensor,
                    payload: torch.Tensor | None, ref_keys: torch.Tensor,
                    ref_ids: torch.Tensor, seed: int,
                    chunk: int = 1 << 21) -> int:
    """Rows whose key, id or (when given) payload differ from the
    reference's (key, id) and the payload made again from the id.
    keys/ids int32 bit storage or carriers, ref_* int64 carriers; the
    lengths must match. Runs on the reference's device in chunks."""
    dev = ref_keys.device
    bad = 0
    for a in range(0, ref_keys.shape[0], chunk):
        b = min(a + chunk, ref_keys.shape[0])
        rk, ri = ref_keys[a:b], ref_ids[a:b]
        wrong = gen.widen(keys[a:b].to(dev)) != rk
        wrong |= gen.widen(ids[a:b].to(dev)) != ri
        if payload is not None:
            want = gen.payload_t(ri, seed)
            wrong |= (payload[a:b].to(dev) != want).any(dim=-1)
        bad += int(wrong.sum())
    return bad


def compare_segments(segments, ref_keys, ref_ids, starts, seed: int) -> int:
    """Mismatches of the program's output segments against the
    reference's ranges: `segments[j]` is (keys, ids, payload, count) of
    range j, or None where the program gave nothing. A missing or extra
    record counts as one mismatch; so does each wrong row."""
    bad = 0
    for j, seg in enumerate(segments):
        lo, hi = int(starts[j]), int(starts[j + 1])
        want = hi - lo
        if seg is None:
            bad += want
            continue
        keys, ids, payload, count = seg
        m = min(int(count), want)
        bad += abs(int(count) - want)
        bad += mismatched_rows(keys[:m], ids[:m],
                               None if payload is None else payload[:m],
                               ref_keys[lo:lo + m], ref_ids[lo:lo + m], seed)
    return bad
