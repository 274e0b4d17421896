"""Distributed two-stage sort — the paper's algorithm with the mesh as a
batch axis on one card.

Port of src/repro/core/exoshuffle.py. The reference runs W mesh devices
under shard_map; here the W workers stay a plan parameter (the spill
runs and reducer offsets depend on it) and become the leading axis of
every tensor. One *shuffle round* is, for all W workers at once:

  map      : bitonic sort of each worker's round records     (kernel)
  partition: offsets at the W-1 worker boundaries            (kernel)
  pack     : fixed-capacity lex-max-padded blocks, (W_src, W_dst, C)
  shuffle  : the tiled all_to_all becomes a transpose to (W_dst, W_src, C)
  merge    : log2(W)-round merge tournament of the W received blocks
             -> one sorted run per worker                    (kernel)

Blocks are padded to capacity = next_pow2(n/W * capacity_factor), and
`overflow` reports whether any block exceeded it (the reference's pmax
becomes any()).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import sortlib
from repro_torch.core.keyspace import KeySpace
from repro_torch.kernels import u32


@dataclasses.dataclass(frozen=True)
class ShuffleConfig:
    """Tunables of the distributed sort (paper §2.1 parameter list)."""

    num_workers: int  # W — the batch axis the sort runs over
    reducers_per_worker: int = 1  # R1; R = W * R1
    capacity_factor: float = 1.5  # block slack over the uniform-key mean
    num_rounds: int = 1  # merge-controller rounds (streaming)
    impl: str = "kernel"  # "kernel" | "ref"
    # R-1 explicit reducer boundaries (sampled quantiles); None = equal split.
    boundaries: tuple[int, ...] | None = None

    @property
    def keyspace(self) -> KeySpace:
        return KeySpace(
            num_reducers=self.num_workers * self.reducers_per_worker,
            num_workers=self.num_workers,
            boundaries=self.boundaries,
        )

    def block_capacity(self, records_per_round: int) -> int:
        """Fixed all_to_all block size for a round of n records/worker."""
        mean = records_per_round / self.num_workers
        cap = int(math.ceil(mean * self.capacity_factor))
        # Power of two so merge run lengths stay aligned.
        p = 1
        while p < cap:
            p *= 2
        return p


def _shuffle_round(keys, vals, *, cfg: ShuffleConfig, capacity: int):
    """One map->partition->all_to_all->merge round for all W workers.

    keys/vals: (W, n) u32, row w = worker w's local records. Returns
    (run_k, run_v, counts, overflow): run_* (W, W*capacity) lex-sorted
    with pads at the tail; counts (W_dst, W_src) int32 records received
    from each source worker; overflow a bool tensor.
    """
    ks = cfg.keyspace
    # --- map: sort the local partitions (paper §2.3 step 1) ---
    sk, sv = sortlib.sort_records(keys, vals, impl=cfg.impl)
    # --- partition at worker boundaries (paper §2.2) ---
    wb = ks.worker_boundaries(keys.device)  # (W-1,)
    starts, counts = sortlib.partition_sorted(sk, wb, impl=cfg.impl)
    bk, bv, overflow = sortlib.gather_range_blocks(sk, sv, starts, counts,
                                                   capacity)
    # --- shuffle: the tiled all_to_all, (W_src, W_dst, C) -> (W_dst, W_src, C)
    rk = bk.transpose(0, 1).contiguous()
    rv = bv.transpose(0, 1).contiguous()
    rcounts = counts.transpose(0, 1)
    # --- merge: the merge task (paper §2.3), a merge tournament ---
    mk, mv = sortlib.merge_runs(rk, rv, impl=cfg.impl)
    return mk, mv, rcounts, overflow


def _config(num_workers, cfg, impl, capacity_factor, **kw) -> ShuffleConfig:
    if cfg is None:
        cfg = ShuffleConfig(num_workers=num_workers, impl=impl,
                            capacity_factor=capacity_factor, **kw)
    assert cfg.num_workers == num_workers, (cfg.num_workers, num_workers)
    assert num_workers & (num_workers - 1) == 0, (
        "worker count must be a power of two (merge tournament)")
    return cfg


def distributed_sort(keys, vals, *, num_workers: int,
                     cfg: ShuffleConfig | None = None, impl: str = "kernel",
                     capacity_factor: float = 1.5, device="cuda"):
    """Globally sort (key, val) records over W batched workers.

    keys/vals: global (N,) uint32 (numpy or u32 tensor), N divisible by
    W; worker d holds [d*N/W, (d+1)*N/W). Returns (sorted_keys,
    sorted_vals, valid_counts, overflow) on `device`:
      sorted_keys/vals: (W * W * capacity,) u32 — worker d's segment is
        its key range, lex-sorted, valid prefix of length valid_counts[d];
      valid_counts: (W,) int32; overflow: bool.
    """
    dev = u32.resolve_device(device)
    w = num_workers
    cfg = _config(w, cfg, impl, capacity_factor)
    keys, vals = u32.as_tensor(keys, dev), u32.as_tensor(vals, dev)
    n = keys.shape[-1] // w
    capacity = cfg.block_capacity(n)
    mk, mv, rcounts, overflow = _shuffle_round(
        keys.reshape(w, n), vals.reshape(w, n), cfg=cfg, capacity=capacity)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    return mk.reshape(-1), mv.reshape(-1), valid, bool(overflow)


def reduce_partitions(sorted_keys, cfg: ShuffleConfig, worker_id: int):
    """Paper §2.4: split worker `worker_id`'s final sorted run (m,) into
    its R1 reducer ranges; returns (starts, counts) of shape (R1,)."""
    if cfg.reducers_per_worker == 1:
        n = sorted_keys.shape[-1]
        dev = sorted_keys.device
        return (torch.zeros((1,), dtype=torch.int32, device=dev),
                torch.full((1,), n, dtype=torch.int32, device=dev))
    lrb = cfg.keyspace.local_reducer_boundaries(sorted_keys.device)
    mine = lrb[int(worker_id)].contiguous()
    return sortlib.partition_sorted(sorted_keys, mine, impl=cfg.impl)
