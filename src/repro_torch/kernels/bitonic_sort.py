"""Row-wise lex sort of (key, val) uint32 records: the map-task sort.

Port of the TPU kernel src/repro/kernels/bitonic_sort.py
(`bitonic_sort_blocks`). Two versions of the same function:

  * the CUDA kernel, csrc/bitonic_sort.cu — the same network run as a
    few passes over the row: tile passes in registers and shared memory
    for distances below TILE, fused global passes of up to FUSE
    substages above it (the source says why, and what bounds it). The
    passes come from `sort_plan`, here, so the CPU tests can check them;
  * the plain version, `bitonic_sort_blocks_plain` — the reference's
    compare-exchange network in torch ops on int64 carriers: each
    (key, val) pair packs into one int64 (u32.pack) whose signed order is
    the lex order, so a compare-exchange is a min/max.

`bitonic_sort_blocks` runs the plain version for a CPU tensor and the
kernel for a CUDA tensor; there is no fallback between the two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, u32

# Records per tile pass: 64 KB of packed u64 (512 threads), so two blocks
# share an SM and one's loads overlap the other's compares (the kernel's
# TILE_MAX). 2^14 tiles (one block an SM) make fewer passes but ran slower.
TILE = 1 << 13
FUSE = 6  # most substages a fused global pass runs (the kernel's FUSE_MAX)


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


def network_substages(b: int) -> list[tuple[int, int]]:
    """The (window, distance) substages of the network over B, in order."""
    return [(1 << w, 1 << d) for w in range(1, b.bit_length())
            for d in range(w - 1, -1, -1)]


def bitonic_network(packed: torch.Tensor) -> torch.Tensor:
    """The full bitonic sorting network over each row of packed (rows, B)."""
    b = packed.shape[-1]
    assert b & (b - 1) == 0, "block must be a power of two"
    for window, dist in network_substages(b):
        packed = _compare_exchange(packed, dist, window)
    return packed


def bitonic_sort_blocks_plain(keys: torch.Tensor, vals: torch.Tensor):
    """The plain torch version: the bitonic network on packed carriers."""
    return u32.unpack(bitonic_network(u32.pack(keys, vals)))


def sort_plan(b: int, tile: int = TILE) -> list[tuple[int, int, int]]:
    """The kernel's passes over rows of B records, as (window, first
    distance, substage count) triples that together run the network's
    substages in order. Pass 0 sorts each tile of min(B, tile) records
    (windows 2..tile); each window w > tile then takes
    ceil(log2(w / tile) / FUSE) fused global passes (distances w/2 ..
    tile, split as evenly as it goes) and one tile pass (distances
    tile/2 .. 1). For B = 2^20: 1 + 8 + 7 = 16 passes. The wrapper always
    uses TILE; a smaller tile lets the CPU tests replay fused passes on
    short rows."""
    tile = min(b, tile)
    assert b & (b - 1) == 0 and tile & (tile - 1) == 0 and (tile > 1 or b == 1)
    lt = tile.bit_length() - 1
    plan = [(2, 1, lt * (lt + 1) // 2)]
    w = 2 * tile
    while w <= b:
        n, d = (w // tile).bit_length() - 1, w // 2
        parts = -(-n // FUSE)
        for i in range(parts):
            c = n // parts + (i < n % parts)
            plan.append((w, d, c))
            d >>= c
        plan.append((w, tile // 2, lt))
        w *= 2
    return plan


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
    nb, b = keys.shape
    ok, ov = torch.empty_like(keys), torch.empty_like(vals)
    if not keys.numel():
        return ok, ov
    tile = min(b, TILE)
    plan = sort_plan(b)
    scratch = (torch.empty((nb, b), dtype=torch.int64, device=keys.device)
               if len(plan) > 1 else 0)
    triples = (ctypes.c_longlong * (3 * len(plan)))(*sum(plan, ()))
    _build.launch("bitonic_sort", keys, vals, ok, ov, scratch, nb, b, tile,
                  ctypes.addressof(triples), len(plan))
    _build.count_launch(bitonic_sort_blocks)
    return ok, ov


bitonic_sort_blocks.launches = 0
