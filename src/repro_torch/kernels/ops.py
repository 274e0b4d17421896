"""Wrappers over the sort/merge/partition kernels: the single-device
primitives core/sortlib.py composes.

Each op takes `impl`:

  - "kernel": the hand-written CUDA kernel for a CUDA tensor, its plain
              torch version for a CPU tensor (the wrappers decide by the
              tensor's device, never by a fallback);
  - "ref":    the torch oracle from kernels/ref.py.

Padding convention (the reference's): variable-length inputs are padded
with the lex-maximal record (0xFFFFFFFF, 0xFFFFFFFF), which sorts to the
tail; callers track true counts and slice. Tensors are u32 tensors
(int32 bit storage, see u32.py).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels import u32
from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
from repro_torch.kernels.merge_sorted import merge_sorted_pairs
from repro_torch.kernels.range_partition import partition_offsets_blocks

PAD_KEY = 0xFFFFFFFF
PAD_VAL = 0xFFFFFFFF
IMPLS = ("kernel", "ref")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: must be one of {IMPLS}")


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_to_pow2(keys: torch.Tensor, vals: torch.Tensor):
    """Pad the trailing axis to the next power of two with lex-max records."""
    n = keys.shape[-1]
    p = next_pow2(n)
    if p == n:
        return keys, vals, n
    shape = keys.shape[:-1] + (p - n,)
    keys = torch.cat([keys, u32.full(shape, PAD_KEY, keys.device)], dim=-1)
    vals = torch.cat([vals, u32.full(shape, PAD_VAL, vals.device)], dim=-1)
    return keys, vals, n


def sort_kv(keys: torch.Tensor, vals: torch.Tensor, *, impl: str = "kernel"):
    """Lexicographic sort along the last axis. Any length; any leading
    dims. Returns tensors of the input shape."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.sort_kv_ref(keys, vals)
    shape = keys.shape
    pk, pv, n = pad_to_pow2(keys.reshape(-1, shape[-1]).contiguous(),
                            vals.reshape(-1, shape[-1]).contiguous())
    sk, sv = bitonic_sort_blocks(pk, pv)
    return sk[:, :n].reshape(shape), sv[:, :n].reshape(shape)


def merge_kv(a_keys, a_vals, b_keys, b_vals, *, impl: str = "kernel"):
    """Merge two sorted runs (leading dims broadcast over rows)."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.merge_kv_ref(a_keys, a_vals, b_keys, b_vals)
    shape = a_keys.shape
    run = shape[-1]
    assert run & (run - 1) == 0, "kernel merge needs power-of-two runs"
    rows = [t.reshape(-1, run).contiguous()
            for t in (a_keys, a_vals, b_keys, b_vals)]
    mk, mv = merge_sorted_pairs(*rows)
    out_shape = shape[:-1] + (2 * run,)
    return mk.reshape(out_shape), mv.reshape(out_shape)


def kway_merge(keys: torch.Tensor, vals: torch.Tensor, *,
               impl: str = "kernel"):
    """Merge K sorted runs -> one sorted run.

    keys, vals: (..., K, L), each (..., k, :) row lex-sorted; K, L powers
    of two. Returns (..., K*L): a tournament of pairwise merges, log2(K)
    rounds — the paper's merge/reduce task.
    """
    shape = keys.shape
    k, run = shape[-2], shape[-1]
    assert k & (k - 1) == 0, "K must be a power of two"
    keys = keys.reshape(-1, k, run)
    vals = vals.reshape(-1, k, run)
    while k > 1:
        nb = keys.shape[0] * (k // 2)
        mk, mv = merge_kv(keys[:, 0::2].reshape(nb, run),
                          vals[:, 0::2].reshape(nb, run),
                          keys[:, 1::2].reshape(nb, run),
                          vals[:, 1::2].reshape(nb, run), impl=impl)
        k //= 2
        run *= 2
        keys = mk.reshape(-1, k, run)
        vals = mv.reshape(-1, k, run)
    out_shape = shape[:-2] + (shape[-2] * shape[-1],)
    return keys.reshape(out_shape), vals.reshape(out_shape)


def partition_offsets(sorted_keys: torch.Tensor, boundaries: torch.Tensor,
                      *, impl: str = "kernel"):
    """offsets[..., j] = #{keys < boundaries[j]} along the last axis."""
    _check_impl(impl)
    if impl == "ref":
        return _ref.partition_offsets_ref(sorted_keys, boundaries)
    shape = sorted_keys.shape
    out = partition_offsets_blocks(
        sorted_keys.reshape(-1, shape[-1]).contiguous(),
        boundaries.contiguous())
    return out.reshape(shape[:-1] + (boundaries.shape[0],))
