"""Row-wise merge of two lex-sorted (key, val) uint32 runs.

Port of the TPU kernel src/repro/kernels/merge_sorted.py
(`merge_sorted_pairs`): row i of a merged with row i of b, (n, L) +
(n, L) -> (n, 2L). ops.kway_merge drives it as a tournament.

  * the CUDA kernel, csrc/merge_sorted.cu — a tiled merge path: a block
    of THREADS threads owns TILE consecutive outputs, finds its window
    of a and b with a warp-wide search (LANES splits a step), stages it
    in shared memory, and each thread merges ITEMS outputs (the source
    says why; tests/test_torch_merge_plan.py replays its co-ranks);
  * the plain version — the reference's network: a ++ reversed(b) is
    bitonic, and one pass of ascending compare-exchanges from distance L
    down to 1 sorts it (packed int64 carriers, min/max).

Both agree bit-for-bit on sorted rows, the only input the contract
admits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, u32
from repro_torch.kernels.bitonic_sort import _compare_exchange

# The kernel's THREADS, ITEMS and LANES: the C entry point refuses a
# launch whose tile, min(2L, TILE), is not its own.
THREADS, ITEMS, LANES = 256, 8, 32
TILE = THREADS * ITEMS


def merge_network(packed: torch.Tensor) -> torch.Tensor:
    """Sort bitonic packed (rows, B) rows: distances B/2 .. 1, ascending."""
    b = packed.shape[-1]
    dist = b // 2
    while dist >= 1:
        packed = _compare_exchange(packed, dist, b)
        dist //= 2
    return packed


def merge_sorted_pairs_plain(a_keys, a_vals, b_keys, b_vals):
    """The plain torch version: bitonic merge of a ++ reversed(b)."""
    packed = torch.cat([u32.pack(a_keys, a_vals),
                        u32.pack(b_keys, b_vals).flip(-1)], dim=-1)
    return u32.unpack(merge_network(packed))


def merge_sorted_pairs(a_keys: torch.Tensor, a_vals: torch.Tensor,
                       b_keys: torch.Tensor, b_vals: torch.Tensor):
    """Merge row i of a_* with row i of b_* (each (n, L) u32, rows
    lex-sorted) into (n, 2L) rows, lex-sorted. L a power of two. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if not (a_keys.shape == a_vals.shape == b_keys.shape == b_vals.shape
            and a_keys.ndim == 2):
        raise ValueError("merge_sorted_pairs needs four equal (n, L) arrays")
    n, run = a_keys.shape
    if run & (run - 1):
        raise ValueError(f"run length {run} must be a power of two")
    if a_keys.device.type == "cpu":
        return merge_sorted_pairs_plain(a_keys, a_vals, b_keys, b_vals)
    u32.require_u32(a_keys, a_vals, b_keys, b_vals)
    ok = torch.empty((n, 2 * run), dtype=a_keys.dtype, device=a_keys.device)
    ov = torch.empty_like(ok)
    _build.launch("merge_sorted", a_keys, a_vals, b_keys, b_vals, ok, ov,
                  n, run, min(2 * run, TILE))
    _build.count_launch(merge_sorted_pairs)
    return ok, ov


merge_sorted_pairs.launches = 0
