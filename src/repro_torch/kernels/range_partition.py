"""Range-partition offsets: out[i, j] = #{k in row i : k < boundaries[j]}.

Port of the TPU kernel src/repro/kernels/range_partition.py
(`partition_offsets_blocks`). The contract is a count, so it holds on
unsorted rows too, and duplicate boundaries give empty slices — the
routing contract of searchsorted side="left" that the host-side
RangePartitioner mirrors with side="right".

  * the CUDA kernel, csrc/range_partition.cu — a (row, key tile) grid,
    block-reduced counts, one integer atomicAdd per block and boundary;
  * the plain version — the same compare-and-count in torch on int64
    carriers, one boundary at a time.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, u32


def searchsorted_reference(sorted_keys, boundaries):
    """Host oracle: (num_blocks, R) int32 numpy searchsorted side="left"
    per row, on numpy uint32 inputs."""
    sk = np.asarray(sorted_keys, dtype=np.uint32)
    bs = np.asarray(boundaries, dtype=np.uint32)
    return np.stack([
        np.searchsorted(row, bs, side="left") for row in sk
    ]).astype(np.int32).reshape(sk.shape[0], bs.shape[0])


def partition_offsets_blocks_plain(keys: torch.Tensor,
                                   boundaries: torch.Tensor) -> torch.Tensor:
    """The plain torch version: count k < b_j per row, per boundary."""
    k = u32.widen(keys)
    cols = [(k < int(b)).sum(dim=-1) for b in u32.widen(boundaries).tolist()]
    if not cols:
        return torch.empty((keys.shape[0], 0), dtype=torch.int32,
                           device=keys.device)
    return torch.stack(cols, dim=-1).to(torch.int32)


def partition_offsets_blocks(sorted_keys: torch.Tensor,
                             boundaries: torch.Tensor) -> torch.Tensor:
    """offsets[i, j] = #{k in row i : k < boundaries[j]}.

    sorted_keys: (num_blocks, B) u32; boundaries: (R,) u32 ascending.
    Returns (num_blocks, R) int32. CPU tensors take the plain version,
    CUDA tensors the kernel.
    """
    if sorted_keys.ndim != 2 or boundaries.ndim != 1:
        raise ValueError(f"keys {tuple(sorted_keys.shape)}, boundaries "
                         f"{tuple(boundaries.shape)}: need (nb, B) and (R,)")
    if sorted_keys.device.type == "cpu":
        return partition_offsets_blocks_plain(sorted_keys, boundaries)
    u32.require_u32(sorted_keys, boundaries)
    nb, b = sorted_keys.shape
    r = boundaries.shape[0]
    out = torch.empty((nb, r), dtype=torch.int32, device=sorted_keys.device)
    if nb and r:
        _build.launch("range_partition", sorted_keys, boundaries, out, nb, b, r)
        _build.count_launch(partition_offsets_blocks)
    return out


partition_offsets_blocks.launches = 0
