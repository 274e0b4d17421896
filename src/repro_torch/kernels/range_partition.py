"""Range-partition offsets: out[i, j] = #{k in row i : k < boundaries[j]}.

Port of the TPU kernel src/repro/kernels/range_partition.py
(`partition_offsets_blocks`). The contract is a count, so it holds on
unsorted rows too, and duplicate boundaries give empty slices — the
routing contract of searchsorted side="left" that the host-side
RangePartitioner mirrors with side="right".

  * the CUDA kernel, csrc/range_partition.cu — one launch a call: a grid
    sized to fill the card streams each row with 16-byte loads, and the
    last block of a row to finish sums the blocks' partial counts;
  * the plain version — the same compare-and-count in torch on int64
    carriers, one boundary at a time.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import _build, u32

BLOCKS_PER_SM = 4  # the grid: about this many blocks on each SM in all
MIN_KEYS_PER_BLOCK = 16384

_scratch_lock = threading.Lock()
#: (device, stream) -> (partials int32, tickets int32 kept zeroed by the
#: kernel). Launches on one stream run in order, so they share it.
_scratch: dict = {}
_sm_count: dict = {}


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


def _blocks_per_row(dev, nb: int, b: int) -> int:
    sms = _sm_count.get(dev)
    if sms is None:
        sms = _sm_count[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    want = -(-BLOCKS_PER_SM * sms // nb)
    return max(1, min(want, -(-b // MIN_KEYS_PER_BLOCK)))


def _scratch_for(dev, n_partial: int, nb: int):
    """The partials and tickets of the current stream, grown to fit."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    with _scratch_lock:
        have = _scratch.get(key)
        if (have is None or have[0].numel() < n_partial
                or have[1].numel() < nb):
            if have is not None:  # freed to the allocator in stream order
                n_partial = max(n_partial, have[0].numel())
                nb = max(nb, have[1].numel())
            have = _scratch[key] = (
                torch.empty(n_partial, dtype=torch.int32, device=dev),
                torch.zeros(nb, dtype=torch.int32, device=dev))
        return have


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
    dev = sorted_keys.device
    out = torch.empty((nb, r), dtype=torch.int32, device=dev)
    if nb and r:
        _build.prepare("range_partition", dev)  # raises before the sizing
        bpr = _blocks_per_row(dev, nb, b)
        partials, tickets = _scratch_for(dev, nb * bpr * r, nb)
        _build.launch("range_partition", sorted_keys, boundaries, out,
                      partials, tickets, nb, b, r, bpr)
        _build.count_launch(partition_offsets_blocks)
    return out


partition_offsets_blocks.launches = 0
