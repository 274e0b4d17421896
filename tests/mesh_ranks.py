"""Rank-side bodies of tests/test_torch_mesh.py.

Each function runs in a process that launch/mesh.spawn_ranks started
(the "spawn" method: a fresh interpreter that imports this module, and
never jax), joins a gloo group on the CPU through the FileStore path it
is given, does its part and returns numpy results to the parent. The
group is left in a `finally` (RankMesh's context manager) even when an
assertion fails, and spawn_ranks stops the other ranks when one raises.
"""
from __future__ import annotations

import os
import time

import torch

W = 8


def _mesh(rank, world, store_path, timeout_s=60.0):
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    return make_test_mesh(W, store_path=store_path, rank=rank, world=world,
                          timeout_s=timeout_s)


def collectives(rank, world, store_path, blocks, rows):
    """all_to_all_tiled of this rank's rows of two global block tensors
    ((W, W, C) and (W, W, C, pw)), any_across of three flag patterns and
    worker_ids."""
    from repro_torch.core.collectives import (all_to_all_tiled, any_across,
                                              worker_ids)

    with _mesh(rank, world, store_path) as mesh:
        lo, hi = mesh.worker_lo, mesh.worker_lo + mesh.workers_per_rank
        mesh.record_exchanges()
        out = {
            "blocks": all_to_all_tiled(torch.from_numpy(blocks[lo:hi]), mesh,
                                       what="blocks").numpy(),
            "rows": all_to_all_tiled(torch.from_numpy(rows[lo:hi]), mesh,
                                     what="rows").numpy(),
            "none": any_across(torch.zeros(3, dtype=torch.bool), mesh),
            "last": any_across(torch.tensor(rank == world - 1), mesh),
            "all": any_across(True, mesh),
            "ids": worker_ids(mesh, W, "cpu").numpy(),
            "log": mesh.exchange_log(),
        }
    return out


def sorts(rank, world, store_path, cases):
    """Every in-memory sort case on this rank's shard; `cases` maps a name
    to (kind, inputs dict, ShuffleConfig fields), kind "dist", "stream"
    or a payload mode. Returns each case's outputs as numpy (u32 as their
    int32 bits)."""
    from repro_torch.core.exoshuffle import (ShuffleConfig, distributed_sort,
                                             distributed_sort_payload)
    from repro_torch.core.streaming import streaming_sort

    out = {}
    with _mesh(rank, world, store_path) as mesh:
        for name, (kind, inp, fields) in cases.items():
            cfg = ShuffleConfig(**fields)
            lo, hi = mesh.share(inp["keys"].shape[0])
            k, v = inp["keys"][lo:hi], inp["vals"][lo:hi]
            if kind == "dist":
                res = distributed_sort(k, v, num_workers=W, cfg=cfg,
                                       mesh=mesh)
            elif kind == "stream":
                res = streaming_sort(k, v, num_workers=W,
                                     num_rounds=cfg.num_rounds, cfg=cfg,
                                     mesh=mesh)
            else:
                res = distributed_sort_payload(
                    k, v, inp["payload"][lo:hi], num_workers=W, mode=kind,
                    cfg=cfg, mesh=mesh)
            out[name] = tuple(t.numpy() if isinstance(t, torch.Tensor)
                              else t for t in res)
    return out


def oocore(rank, world, store_path, root, jobs):
    """The out-of-core sort of each (tag, plan) in `jobs`, in order, on
    an ObjectStore at `root` shared by all ranks; returns the merged
    reports' counters (every rank returns the same)."""
    from repro_torch.io.object_store import ObjectStore
    from repro_torch.shuffle.sort import sort_shuffle_job

    out = {}
    with _mesh(rank, world, store_path) as mesh:
        store = ObjectStore(root)
        for tag, plan in jobs:
            rep = sort_shuffle_job(store, "b", num_workers=W, plan=plan,
                                   device="cpu", mesh=mesh).run()
            out[tag] = {"bytes_read": rep.stats.bytes_read,
                        "bytes_written": rep.stats.bytes_written,
                        "spill_objects": rep.spill_objects,
                        "output_objects": rep.output_objects,
                        "num_workers": rep.num_workers,
                        "num_reducers": rep.num_reducers}
    return out


def dead_rank(rank, world, store_path, result_dir, timeout_s):
    """Rank 1 dies right after joining; rank 0 then tries an all_to_all
    and writes what happened (the exception and how long it took) to
    `result_dir`. Run in plain spawned processes, not spawn_ranks: that
    would stop rank 0 as soon as rank 1 exits."""
    from repro_torch.core.collectives import all_to_all_tiled

    mesh = _mesh(rank, world, store_path, timeout_s=timeout_s)
    if rank == 1:
        os._exit(3)
    t0 = time.perf_counter()
    try:
        all_to_all_tiled(torch.zeros((W // world, W, 4), dtype=torch.int32),
                         mesh)
        err = None
    except Exception as e:  # the point: the collective must raise
        err = f"{type(e).__name__}: {e}"
    with open(os.path.join(result_dir, "rank0.txt"), "w") as f:
        f.write(f"{time.perf_counter() - t0}\n{err}\n")
    os._exit(0)  # the group cannot be left cleanly with a dead peer
