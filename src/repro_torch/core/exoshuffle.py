"""Distributed two-stage sort — the paper's algorithm over W workers held
as a batch axis by one process, or split over the ranks of a mesh.

Port of src/repro/core/exoshuffle.py. The reference runs W mesh devices
under shard_map; here the W workers stay a plan parameter (the spill
runs and reducer offsets depend on it) and become the leading axis of
every tensor: all W of them without a mesh, the rank's W/G with a
launch/mesh.RankMesh. One *shuffle round* is, for those workers at once:

  map      : bitonic sort of each worker's round records     (kernel)
  partition: offsets at the W-1 worker boundaries            (kernel)
  pack     : fixed-capacity lex-max-padded blocks, (W/G_src, W_dst, C)
  shuffle  : the tiled all_to_all to (W/G_dst, W_src, C)
             (core/collectives: a transpose without a mesh)
  merge    : log2(W)-round merge tournament of the W received blocks
             -> one sorted run per worker                    (kernel)

Blocks are padded to capacity = next_pow2(n/W * capacity_factor), and
`overflow` reports whether any block on any rank exceeded it (the
reference's pmax: collectives.any_across). `distributed_sort_payload`
sorts whole records: the payload rows follow their headers by one of
core/payload.py's modes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import sortlib
from repro_torch.core.collectives import (all_to_all_tiled, any_across,
                                          worker_ids)
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


def _exchange(keys, vals, *, cfg: ShuffleConfig, capacity: int, mesh=None):
    """Map, partition and all_to_all of one round for the held workers.

    keys/vals: (Wl, n) u32, row w = local worker w's records (Wl = W
    without a mesh, W/G with one). Returns (bv, rk, rv, rcounts,
    overflow): bv (Wl_src, W_dst, C) the sent blocks' vals; rk/rv
    (Wl_dst, W_src, C) the received blocks; rcounts (Wl_dst, W_src)
    int32 records received from each source worker; overflow a bool
    tensor of this process's blocks alone.
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
    rk = all_to_all_tiled(bk, mesh, what="keys")
    rv = all_to_all_tiled(bv, mesh, what="vals")
    rcounts = all_to_all_tiled(counts, mesh, what="counts")
    return bv, rk, rv, rcounts, overflow


def _shuffle_round(keys, vals, *, cfg: ShuffleConfig, capacity: int,
                   mesh=None):
    """One map->partition->all_to_all->merge round for the held workers.

    keys/vals: (Wl, n) u32. Returns (run_k, run_v, counts, overflow):
    run_* (Wl, W*capacity) lex-sorted with pads at the tail; counts
    (Wl_dst, W_src) int32; overflow a bool tensor (this process's).
    """
    _, rk, rv, rcounts, overflow = _exchange(keys, vals, cfg=cfg,
                                             capacity=capacity, mesh=mesh)
    # --- merge: the merge task (paper §2.3), a merge tournament ---
    mk, mv = sortlib.merge_runs(rk, rv, impl=cfg.impl)
    return mk, mv, rcounts, overflow


def config_from_reference(fields: dict) -> ShuffleConfig:
    """A ShuffleConfig from `dataclasses.asdict` of the reference
    package's: impl "pallas" maps to "kernel", "ref" stays "ref"."""
    fields = dict(fields)
    impl = fields.get("impl", "kernel")
    fields["impl"] = {"pallas": "kernel", "ref": "ref"}.get(impl, impl)
    if fields.get("boundaries") is not None:
        fields["boundaries"] = tuple(int(b) for b in fields["boundaries"])
    return ShuffleConfig(**fields)


def _config(num_workers, cfg, impl, capacity_factor, **kw) -> ShuffleConfig:
    if cfg is None:
        cfg = ShuffleConfig(num_workers=num_workers, impl=impl,
                            capacity_factor=capacity_factor, **kw)
    assert cfg.num_workers == num_workers, (cfg.num_workers, num_workers)
    assert num_workers & (num_workers - 1) == 0, (
        "worker count must be a power of two (merge tournament)")
    return cfg


def held_workers(num_workers: int, mesh, device) -> tuple[int, torch.device]:
    """(workers this process holds, their device): all W on `device`
    without a mesh, the rank's W/G on its own device with one."""
    if mesh is None:
        return num_workers, u32.resolve_device(device)
    if mesh.num_workers != num_workers:
        raise ValueError(f"num_workers={num_workers} on {mesh}")
    return mesh.workers_per_rank, mesh.device


def distributed_sort(keys, vals, *, num_workers: int,
                     cfg: ShuffleConfig | None = None, impl: str = "kernel",
                     capacity_factor: float = 1.5, device="cuda", mesh=None):
    """Globally sort (key, val) records over W workers.

    keys/vals: (N,) uint32 (numpy or u32 tensor) of the held workers —
    all N records without a mesh, the rank's shard of N/G with one —
    divisible by the held workers; worker d holds [d*N/W, (d+1)*N/W).
    Returns (sorted_keys, sorted_vals, valid_counts, overflow) of the
    held workers on `device` (on the mesh's device with a mesh):
      sorted_keys/vals: (Wl * W * capacity,) u32 — worker d's segment is
        its key range, lex-sorted, valid prefix of length valid_counts[d];
      valid_counts: (Wl,) int32; overflow: bool, the same on every rank.
    """
    w = num_workers
    wl, dev = held_workers(w, mesh, device)
    cfg = _config(w, cfg, impl, capacity_factor)
    keys, vals = u32.as_tensor(keys, dev), u32.as_tensor(vals, dev)
    n = keys.shape[-1] // wl
    capacity = cfg.block_capacity(n)
    mk, mv, rcounts, overflow = _shuffle_round(
        keys.reshape(wl, n), vals.reshape(wl, n), cfg=cfg, capacity=capacity,
        mesh=mesh)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    return mk.reshape(-1), mv.reshape(-1), valid, any_across(overflow, mesh)


PAYLOAD_MODES = ("through", "late")


def _sort_shard_payload(keys, ids, payload, *, cfg: ShuffleConfig,
                        mode: str, mesh=None):
    """Whole-record sort for the held workers: headers through the merge,
    payload rows by `mode` ("through" = paper-faithful, "late" =
    deferred fetch). keys/ids (Wl, n) u32, payload (Wl, n, pw) u32.
    Returns (mk, mv, pout, valid, overflow): mk/mv (Wl, W*C), pout
    (Wl, W*C, pw), valid (Wl,) int32, overflow a bool (every rank's)."""
    from repro_torch.core import payload as pay

    wl, n = keys.shape
    w = cfg.num_workers
    capacity = cfg.block_capacity(n)
    bv, rk, rv, rcounts, overflow = _exchange(keys, ids, cfg=cfg,
                                              capacity=capacity, mesh=mesh)
    if mode == "through":
        # Payload rows ride the same exchange, block-aligned with their
        # headers; local row = min(id - my*n, n-1) in u32 arithmetic, so
        # pad ids take the sender's last row.
        my = worker_ids(mesh, w, keys.device)
        diff = (u32.widen(bv) - my[:, None, None] * n) & u32.MASK
        local_row = torch.clamp(diff, max=n - 1).reshape(wl, -1)
        bp = pay.take_rows(payload, local_row)
        rp = pay.exchange_payload_blocks(
            bp.reshape(wl, w, capacity, bp.shape[-1]), mesh)
    mk, mv = sortlib.merge_runs(rk, rv, impl=cfg.impl)
    if mode == "through":
        pout = pay.align_payload_to_merge(
            rv.reshape(wl, -1), rp.reshape(wl, -1, rp.shape[-1]), mv)
        fetch_overflow = False
    else:
        pout, fetch_overflow = pay.late_fetch_payload(
            mv, payload, num_workers=w, records_per_worker=n,
            capacity=cfg.block_capacity(mv.shape[-1]), impl=cfg.impl,
            mesh=mesh)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    return mk, mv, pout, valid, any_across(overflow | fetch_overflow, mesh)


def distributed_sort_payload(keys, ids, payload, *, num_workers: int,
                             mode: str = "through",
                             cfg: ShuffleConfig | None = None,
                             impl: str = "kernel",
                             capacity_factor: float = 1.5, device="cuda",
                             mesh=None):
    """Sort whole records: (key, global id, payload row).

    keys/ids: (N,) uint32 (numpy or u32 tensors) of the held workers, as
    distributed_sort's (the rank's shard with a mesh); ids globally
    unique with id // (N/W) == producing worker (the data/gensort.py
    layout), N the global count. payload: (N, pw) uint32, the held
    workers' rows. Returns (sorted_keys, sorted_ids, payload_rows,
    valid_counts, overflow) of the held workers on `device` (the mesh's
    device with a mesh), flattened as distributed_sort's: payload_rows[i]
    (Wl*W*C, pw) is the payload of the record at output position i. In
    the "late" mode the rows at pad positions are unspecified, as in the
    reference.
    """
    if mode not in PAYLOAD_MODES:
        raise ValueError(f"unknown payload mode {mode!r}: must be one of "
                         f"{PAYLOAD_MODES}")
    w = num_workers
    wl, dev = held_workers(w, mesh, device)
    cfg = _config(w, cfg, impl, capacity_factor)
    keys, ids = u32.as_tensor(keys, dev), u32.as_tensor(ids, dev)
    payload = u32.as_tensor(payload, dev)
    n = keys.shape[-1] // wl
    pw = payload.shape[-1]
    mk, mv, pout, valid, ovf = _sort_shard_payload(
        keys.reshape(wl, n), ids.reshape(wl, n), payload.reshape(wl, n, pw),
        cfg=cfg, mode=mode, mesh=mesh)
    return mk.reshape(-1), mv.reshape(-1), pout.reshape(-1, pw), valid, ovf


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
