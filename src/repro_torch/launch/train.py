"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 200 --batch 8 --seq 128 --reduced --ckpt-dir build/ck \
      [--device cuda|cpu]

Twin of src/repro/launch/train.py with the same flags, plus --device
(default the card; raises without one). Runs the full stack: config ->
model -> train step -> exoshuffle-shuffled data pipeline -> checkpoints
every --ckpt-every steps and at the end -> automatic restart from the
latest checkpoint. The weights are drawn from a torch.Generator seeded
0 on the device (the reference's PRNGKey(0) has no torch twin). Every
arch trains: an encdec model's batches get frame embeddings (drawn from
a generator seeded with the step, so a restarted run sees the same),
which the reference's driver does not supply; a vlm trains on text
alone, as the reference's does.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import u32
from repro_torch.models import api as mapi
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          init_train_state, make_train_step)


def main(argv=None):
    """Returns {"loss": the last step's, "losses": {step: loss} of the
    logged steps, "start": the step it began at, "tokens_per_s",
    "save_s": [seconds of each checkpoint save], "load_s": seconds of the
    restore or None}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = u32.resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32", remat=False)
    model = mapi.build(cfg)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=args.lr, warmup_steps=10,
                                     total_steps=args.steps))

    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch,
                                    num_samples=args.batch * 1024),
                         device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"start": 0, "losses": {}, "save_s": [], "load_s": None}

    def save(state, step):
        t0 = time.perf_counter()
        ckpt.save(state, args.ckpt_dir, step)
        out["save_s"].append(time.perf_counter() - t0)

    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        t0 = time.perf_counter()
        state, out["start"] = ckpt.load(abstract_train_state(model, tcfg),
                                        args.ckpt_dir, device=dev)
        sync()
        out["load_s"] = time.perf_counter() - t0
        print(f"restored checkpoint at step {out['start']}")
    else:
        state = init_train_state(
            model, torch.Generator(device=dev).manual_seed(0), tcfg)

    step_fn = make_train_step(model, tcfg)
    start = out["start"]
    metrics = None
    t0 = time.time()
    for step in range(start, args.steps):
        batch = data.batch_at(step)
        if cfg.family == "encdec":
            batch.update(mapi.stub_inputs(
                cfg, args.batch, args.seq,
                torch.Generator(device=dev).manual_seed(step)))
        state, metrics = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            out["losses"][step] = loss
            tps = args.batch * args.seq * (step - start + 1) / (time.time() - t0)
            out["tokens_per_s"] = tps
            print(f"step {step:5d}  loss {loss:8.4f}  lr {float(metrics['lr']):.2e}"
                  f"  tok/s {tps:,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(state, step + 1)
    if args.ckpt_dir:
        save(state, args.steps)
    out["loss"] = float(metrics["loss"]) if metrics is not None else None
    return out


if __name__ == "__main__":
    main()
