"""Single-device sort/merge primitives used by the batched shuffle.

Port of src/repro/core/sortlib.py — the analogue of the paper's C++
component (§2.6): "sorting and partitioning records, and merging sorted
record arrays". Each primitive is backed by a kernel (kernels/) with a
torch oracle (kernels/ref.py); `impl` selects between them. Every
function takes any leading dims, so the W mesh workers ride along as a
batch axis.

Records are (key: uint32, val: uint32) pairs in u32 tensors; `val` is a
rank into an external payload table.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, u32

PAD_KEY = ops.PAD_KEY
PAD_VAL = ops.PAD_VAL


def sort_records(keys, vals, *, impl: str = "kernel"):
    """Paper map-task step 1: sort a partition in memory."""
    return ops.sort_kv(keys, vals, impl=impl)


def merge_runs(keys, vals, *, impl: str = "kernel"):
    """Paper merge/reduce task: merge K sorted runs. keys/vals: (..., K, L)."""
    return ops.kway_merge(keys, vals, impl=impl)


def partition_sorted(sorted_keys, boundaries, *, impl: str = "kernel"):
    """Paper map-task step 2: slice a sorted partition at range boundaries.

    Returns (starts, counts): (..., P) int32 start and size of each of the
    P = len(boundaries)+1 ranges.
    """
    n = sorted_keys.shape[-1]
    off_internal = ops.partition_offsets(sorted_keys, boundaries, impl=impl)
    lead = off_internal.shape[:-1]
    zeros = torch.zeros(lead + (1,), dtype=off_internal.dtype,
                        device=off_internal.device)
    ns = torch.full(lead + (1,), n, dtype=off_internal.dtype,
                    device=off_internal.device)
    starts = torch.cat([zeros, off_internal], dim=-1)
    ends = torch.cat([off_internal, ns], dim=-1)
    return starts, ends - starts


def gather_range_blocks(sorted_keys, sorted_vals, starts, counts,
                        capacity: int):
    """Pack each range slice into a fixed-capacity padded block.

    sorted_keys/vals: (..., n); starts/counts: (..., P). Returns
    (blocks_k, blocks_v): (..., P, capacity) with lex-max padding, and
    overflow: a bool tensor, True if any count exceeded capacity — the
    paper's fixed-size block protocol.
    """
    n = sorted_keys.shape[-1]
    lead = sorted_keys.shape[:-1]
    p = starts.shape[-1]
    c = torch.arange(capacity, dtype=torch.int64, device=starts.device)
    src = starts.to(torch.int64)[..., None] + c  # (..., P, C)
    valid = c < counts.to(torch.int64)[..., None]
    src = src.clamp(0, n - 1).reshape(lead + (p * capacity,))
    bk = torch.gather(sorted_keys, -1, src).reshape(lead + (p, capacity))
    bv = torch.gather(sorted_vals, -1, src).reshape(lead + (p, capacity))
    bk = torch.where(valid, bk, u32.PAD)
    bv = torch.where(valid, bv, u32.PAD)
    overflow = torch.any(counts > capacity)
    return bk, bv, overflow
