"""Row-wise lex sort of (key, val) uint32 records: the map-task sort.

Port of the TPU kernel src/repro/kernels/bitonic_sort.py
(`bitonic_sort_blocks`). Two versions of the same function:

  * the CUDA kernel, csrc/bitonic_sort.cu — a bitonic network split into
    shared-memory tile passes and device-memory substages (the source
    says why, and what bounds it);
  * the plain version, `bitonic_sort_blocks_plain` — the reference's
    compare-exchange network in torch ops on int64 carriers: each
    (key, val) pair packs into one int64 (u32.pack) whose signed order is
    the lex order, so a compare-exchange is a min/max.

`bitonic_sort_blocks` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback between the two.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, u32


def _compare_exchange(packed: torch.Tensor, dist: int, window: int):
    """One bitonic substage at distance `dist` within stage `window` on
    packed (rows, B) int64: pairs (i, i + dist) sort ascending iff their
    window index is even (the reference's direction rule)."""
    rows, b = packed.shape
    groups = b // (2 * dist)
    x = packed.reshape(rows, groups, 2, dist)
    lo, hi = x[:, :, 0], x[:, :, 1]
    mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
    g = torch.arange(groups, device=packed.device)
    asc = ((g * (2 * dist)) // window % 2 == 0).view(1, groups, 1)
    return torch.stack([torch.where(asc, mn, mx), torch.where(asc, mx, mn)],
                       dim=2).reshape(rows, b)


def bitonic_network(packed: torch.Tensor) -> torch.Tensor:
    """The full bitonic sorting network over each row of packed (rows, B)."""
    b = packed.shape[-1]
    assert b & (b - 1) == 0, "block must be a power of two"
    window = 2
    while window <= b:
        dist = window // 2
        while dist >= 1:
            packed = _compare_exchange(packed, dist, window)
            dist //= 2
        window *= 2
    return packed


def bitonic_sort_blocks_plain(keys: torch.Tensor, vals: torch.Tensor):
    """The plain torch version: the bitonic network on packed carriers."""
    return u32.unpack(bitonic_network(u32.pack(keys, vals)))


def _check(keys, vals):
    if keys.ndim != 2 or keys.shape != vals.shape:
        raise ValueError(f"keys {tuple(keys.shape)} / vals "
                         f"{tuple(vals.shape)}: need equal (num_blocks, B)")
    b = keys.shape[1]
    if b & (b - 1):
        raise ValueError(f"block size {b} must be a power of two")


def bitonic_sort_blocks(keys: torch.Tensor, vals: torch.Tensor):
    """Sort each row of (num_blocks, B) u32 (key, val) pairs
    lexicographically; B a power of two. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    _check(keys, vals)
    if keys.device.type == "cpu":
        return bitonic_sort_blocks_plain(keys, vals)
    u32.require_u32(keys, vals)
    ok, ov = torch.empty_like(keys), torch.empty_like(vals)
    _build.launch("bitonic_sort", keys, vals, ok, ov, keys.shape[0],
                  keys.shape[1])
    _build.count_launch(bitonic_sort_blocks)
    return ok, ov


bitonic_sort_blocks.launches = 0
