"""Train a ~30M-parameter MoE with exoshuffle sort dispatch for a few hundred
steps — the paper's technique inside a real training loop.

  PYTHONPATH=src python -m repro_torch.examples.train_moe --steps 300 \
      [--device cuda|cpu] [--ckpt-dir DIR]

Twin of examples/train_moe.py: a scaled qwen2-moe family config (8
experts, top-2, d_model 256, sort dispatch, capacity factor 2.0,
float32) with the exoshuffle epoch-shuffled data pipeline, checkpointing
every 100 steps. The reference routes over the model axis of a 2x4 mesh
of devices; here that mesh is a batch axis of the dispatch (dp=2 data
shards x ep_size=4 expert shards, core/moe_dispatch.sort_dispatch) on
one device. The weights are drawn from a torch.Generator seeded 0 on the
device, unless the caller hands `main` a model.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import u32
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


def main(argv=None, *, params=None):
    """`params`: a trainable model to start from (e.g. the reference's
    weights through `params_from_reference(..., trainable=True)`).
    Returns {"losses": every step's loss, "tokens_per_s", "params"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_moe_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = u32.resolve_device(args.device)
    cfg = example_config()
    model = mapi.build(cfg, ep_size=EP, dp=DP)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=20,
                                     total_steps=args.steps))
    if params is None:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), tcfg)
    else:
        state = train_state_of(params, tcfg)

    step_fn = make_train_step(model, tcfg)
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
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"({tps:,.0f} tok/s)")
        if (step + 1) % 100 == 0:
            ckpt.save(state, args.ckpt_dir, step + 1)
            print(f"checkpointed at {step + 1}")
    n_params = sum(p.numel() for p in state["params"].parameters())
    losses = [float(x) for x in losses]
    print(f"done: {n_params/1e6:.1f}M params, final loss {losses[-1]:.4f}")
    return {"losses": losses, "tokens_per_s": tps, "params": n_params}


if __name__ == "__main__":
    main()
