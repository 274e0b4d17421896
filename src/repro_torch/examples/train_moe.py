"""Train a ~30M-parameter MoE with exoshuffle sort dispatch for a few hundred
steps — the paper's technique inside a real training loop.

  PYTHONPATH=src python -m repro_torch.examples.train_moe --steps 300 \
      [--device cuda|cuda:i|cpu] [--ckpt-dir DIR] [--ranks 8]
      [--mesh data=D,model=M] [--backend nccl|gloo]

Twin of examples/train_moe.py: a scaled qwen2-moe family config (8
experts, top-2, d_model 256, sort dispatch, capacity factor 2.0,
float32) with the exoshuffle epoch-shuffled data pipeline, checkpointing
every 100 steps. The reference routes over the model axis of a 2x4 mesh
of devices. With --ranks 8 (or under torchrun with 8 ranks) so does
this: 8 ranks of one torch.distributed group (launch/mesh.py) with axes
data 2 x model 4, each holding 2 of the 8 experts, 1/4 of every
projection, of the shared experts' width and of the vocabulary
(tensor parallelism, with the sequence split between the blocks), and
its data row of every batch; the dispatch's all_to_all runs over its
"model" subgroup and the gradients are averaged over "data"
(train/train_step.py). --mesh data=D,model=M trains over another
layout of D * M ranks. Without
ranks, that mesh is a batch axis of the dispatch (dp=2 data shards x
ep_size=4 expert shards, core/moe_dispatch.sort_dispatch) in one
process. The weights are drawn from a torch.Generator seeded 0 on the
device (every rank draws them all and keeps its part), unless the
caller hands `main` a model.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import u32
from repro_torch.launch.mesh import (init_rank_mesh, parse_axes,
                                     spawn_ranks, under_torchrun)
from repro_torch.launch.sharding import rank_split
from repro_torch.models import api as mapi
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, train_state_of,
                                          init_train_state, make_train_step)

DP, EP = 2, 4  # the reference's ("data", "model") mesh


def example_config():
    """The reference example's ~100M-class MoE of the qwen2-moe family."""
    return dataclasses.replace(
        get("qwen2-moe-a2.7b"),
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_head=32,
        vocab=8192, n_experts=8, top_k=2, d_ff_expert=512, shared_d_ff=512,
        dispatch_impl="sort", moe_capacity_factor=2.0, dtype="float32",
        remat=False, attn_chunk=64, train_microbatches=1,
    )


MESH = {"data": DP, "model": EP}


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_moe_ckpt")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1, choices=(1, DP * EP),
                    help="1, or the ranks of the reference's data 2 x "
                         "model 4 mesh (spawned here unless run under "
                         "torchrun)")
    ap.add_argument("--mesh", type=parse_axes, default=None,
                    help="data=D,model=M: train over D * M ranks of this "
                         "layout instead of the reference's")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of the ranks (default: nccl "
                         "on cuda, gloo on cpu)")
    return ap


def main(argv=None, *, params=None):
    """`params`: a trainable model to start from (e.g. the reference's
    weights through `params_from_reference(..., trainable=True)`; one
    process only). Returns {"losses": every step's loss, "tokens_per_s",
    "params", "ranks", "mesh"} (over ranks, rank 0's; every rank's
    losses must be the same)."""
    args = _parser().parse_args(argv)
    axes = args.mesh or MESH
    world = math.prod(axes.values())
    if under_torchrun():
        with init_rank_mesh(world, backend=args.backend, device=args.device,
                            axes=axes) as mesh:
            return run(args, mesh)
    if args.ranks == 1 and args.mesh is None:
        return run(args, None, params)
    if params is not None:
        raise ValueError("train_moe: params= is for one process")
    out = spawn_ranks(_rank_main, world, args, axes)
    for r in out[1:]:
        if r["losses"] != out[0]["losses"]:
            raise RuntimeError(f"train_moe: rank {r['rank']}'s losses "
                               f"{r['losses']} differ from rank 0's "
                               f"{out[0]['losses']}")
    return out[0]


def _rank_main(rank: int, world: int, store_path: str, args, axes) -> dict:
    with init_rank_mesh(world, backend=args.backend, device=args.device,
                        rank=rank, world=world, store_path=store_path,
                        axes=axes) as mesh:
        return run(args, mesh)


def run(args, mesh, params=None) -> dict:
    """The training loop in one process (`mesh` None) or on one rank of
    the data 2 x model 4 mesh (rank 0 prints)."""
    lead = mesh is None or mesh.rank == 0
    dev = u32.resolve_device(args.device) if mesh is None else mesh.device
    cfg = example_config()
    model = (mapi.build(cfg, ep_size=EP, dp=DP) if mesh is None
             else mapi.build(cfg, mesh=mesh))
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=20,
                                     total_steps=args.steps))
    if params is None:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), tcfg)
    else:
        state = train_state_of(params, tcfg)

    step_fn = make_train_step(model, tcfg, mesh=mesh)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch,
                                    num_samples=args.batch * 64), device=dev)
    losses = []  # loss tensors: read at the log steps and at the end
    tps = 0.0
    t0 = time.time()
    for step in range(args.steps):
        state, m = step_fn(state, data.batch_at(step))
        losses.append(m["loss"])
        if step % 25 == 0 or step == args.steps - 1:
            tps = args.batch * args.seq * (step + 1) / (time.time() - t0)
            if lead:
                print(f"step {step:4d} loss {float(m['loss']):.4f} "
                      f"({tps:,.0f} tok/s)")
        if (step + 1) % 100 == 0:
            ckpt.save(state, args.ckpt_dir, step + 1, mesh=mesh)
            if lead:
                print(f"checkpointed at {step + 1}")
    # the whole model's parameters: a rank holds 1/tp of each split one
    split = rank_split(state["params"])
    tp = 1 if mesh is None else mesh.size_of("model")
    n_params = sum(p.numel() * (tp if n in split else 1)
                   for n, p in state["params"].named_parameters())
    losses = [float(x) for x in losses]
    if lead:
        print(f"done: {n_params/1e6:.1f}M params, final loss "
              f"{losses[-1]:.4f}")
    return {"losses": losses, "tokens_per_s": tps, "params": n_params,
            "ranks": 1 if mesh is None else mesh.world,
            "rank": 0 if mesh is None else mesh.rank,
            "mesh": None if mesh is None else dict(mesh.axes)}


if __name__ == "__main__":
    main()
