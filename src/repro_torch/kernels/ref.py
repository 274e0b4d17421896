"""Torch oracles for every kernel in this package.

The counterpart of the reference's kernels/ref.py: each function defines
the semantic contract its kernel must meet bit-for-bit. They sort with
torch.sort / torch.searchsorted on int64 carriers (see u32.py), which is
why they are oracles and never the main path on a card.

Records are (key: uint32, val: uint32) pairs held as u32 tensors; all
sorts are lexicographic on (key, val), and on (key, val, idx) for the
indexed variants.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import u32


def sort_kv_ref(keys: torch.Tensor, vals: torch.Tensor):
    """Lexicographic sort of (key, val) pairs along the last axis."""
    packed, _ = torch.sort(u32.pack(keys, vals), dim=-1)
    return u32.unpack(packed)


def merge_kv_ref(a_keys, a_vals, b_keys, b_vals):
    """Merge two lex-sorted (key, val) runs along the last axis."""
    return sort_kv_ref(torch.cat([a_keys, b_keys], dim=-1),
                       torch.cat([a_vals, b_vals], dim=-1))


def sort_kvi_ref(keys, vals, idx):
    """Lexicographic sort of (key, val, idx) triples along the last axis
    (idx int32, compared last): a stable sort by packed (key, val) of
    the triples pre-sorted by idx."""
    by_idx = torch.sort(idx.to(torch.int64), dim=-1, stable=True).indices
    packed = torch.gather(u32.pack(keys, vals), -1, by_idx)
    order = torch.gather(by_idx, -1,
                         torch.sort(packed, dim=-1, stable=True).indices)
    return (torch.gather(keys, -1, order), torch.gather(vals, -1, order),
            torch.gather(idx, -1, order))


def merge_kvi_ref(a_keys, a_vals, a_idx, b_keys, b_vals, b_idx):
    """Merge two triple-lex-sorted indexed runs along the last axis."""
    return sort_kvi_ref(torch.cat([a_keys, b_keys], dim=-1),
                        torch.cat([a_vals, b_vals], dim=-1),
                        torch.cat([a_idx, b_idx], dim=-1))


def partition_offsets_ref(sorted_keys, boundaries):
    """offsets[..., j] = #{i : keys[..., i] < b_j} (searchsorted, left)."""
    lead = sorted_keys.shape[:-1]
    flat = u32.widen(sorted_keys).reshape(-1, sorted_keys.shape[-1])
    b = u32.widen(boundaries).reshape(1, -1).expand(flat.shape[0], -1)
    out = torch.searchsorted(flat, b.contiguous(), side="left")
    return out.to(torch.int32).reshape(lead + (boundaries.shape[0],))


def histogram_ref(keys, boundaries):
    """Counts per bucket for *unsorted* keys: bucket j covers
    [boundaries[j-1], boundaries[j]) with boundaries[-1] implicit 0."""
    srt, _ = sort_kv_ref(keys, torch.zeros_like(keys))
    off = partition_offsets_ref(srt, boundaries)
    prev = torch.cat([torch.zeros(off.shape[:-1] + (1,), dtype=off.dtype,
                                  device=off.device), off[..., :-1]], dim=-1)
    return off - prev
