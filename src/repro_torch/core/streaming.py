"""Round-pipelined two-stage sort — the paper's full structure.

Port of src/repro/core/streaming.py. The reference runs `lax.scan` over
`num_rounds` rounds under shard_map; here a Python loop runs the rounds
on the (Wl, rounds, per_round) batched layout of the held workers (all
W, or a rank's W/G with a launch/mesh.RankMesh):

  Stage 1 (map+shuffle+merge): each round sorts 1/num_rounds of every
      worker's shard, exchanges the partitioned blocks (the tiled
      all_to_all of core/collectives: a transpose without a mesh, a
      collective across ranks with one) and merges the W received
      blocks into ONE sorted run per worker — the merge controller's
      bounded buffer.

  Stage 2 (reduce): a merge tournament over the num_rounds runs yields
      each worker's final sorted output, sliceable into R1 reducer
      partitions (core.exoshuffle.reduce_partitions).
"""
from __future__ import annotations

import torch

from repro_torch.core import sortlib
from repro_torch.core.collectives import any_across
from repro_torch.core.exoshuffle import (ShuffleConfig, _config,
                                         _shuffle_round, held_workers)
from repro_torch.kernels import u32


def streaming_sort(keys, vals, *, num_workers: int, num_rounds: int,
                   cfg: ShuffleConfig | None = None, impl: str = "kernel",
                   capacity_factor: float = 1.5, device="cuda", mesh=None):
    """Two-stage streaming sort (see module docstring).

    Same contract as core.exoshuffle.distributed_sort (the rank's shard
    in, its workers' outputs out, with a mesh), plus `num_rounds` (a
    power of two, for the stage-2 merge tournament). Returns (sk, si,
    valid_counts, overflow): sk/si (Wl * rounds*W*C,) u32 on `device`,
    each worker's segment lex-sorted with pads at its tail;
    valid_counts (Wl,) int32; overflow a bool, the same on every rank.
    """
    w = num_workers
    wl, dev = held_workers(w, mesh, device)
    cfg = _config(w, cfg, impl, capacity_factor, num_rounds=num_rounds)
    assert num_rounds & (num_rounds - 1) == 0, "rounds must be a power of two"
    keys, vals = u32.as_tensor(keys, dev), u32.as_tensor(vals, dev)
    n = keys.shape[-1] // wl
    rounds = cfg.num_rounds
    assert n % rounds == 0
    per_round = n // rounds
    capacity = cfg.block_capacity(per_round)
    k_rounds = keys.reshape(wl, rounds, per_round)
    v_rounds = vals.reshape(wl, rounds, per_round)

    # ---- Stage 1: map + shuffle + merge, one round per loop step ----
    runs_k, runs_v, counts, overflow = [], [], [], []
    for r in range(rounds):
        mk, mv, rcounts, ovf = _shuffle_round(
            k_rounds[:, r].contiguous(), v_rounds[:, r].contiguous(),
            cfg=cfg, capacity=capacity, mesh=mesh)
        runs_k.append(mk)
        runs_v.append(mv)
        counts.append(rcounts.sum(dim=-1))
        overflow.append(ovf)
    run_k = torch.stack(runs_k, dim=1)  # (Wl, rounds, W*C): the spilled runs
    run_v = torch.stack(runs_v, dim=1)

    # ---- Stage 2: reduce — merge the spilled runs ----
    if rounds == 1:
        fk, fv = run_k[:, 0], run_v[:, 0]
    else:
        fk, fv = sortlib.merge_runs(run_k, run_v, impl=cfg.impl)

    valid = torch.stack(counts, dim=-1).sum(dim=-1).to(torch.int32)
    any_overflow = any_across(torch.stack(overflow), mesh)
    return fk.reshape(-1), fv.reshape(-1), valid, any_overflow
