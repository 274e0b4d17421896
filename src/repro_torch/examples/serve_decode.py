"""Serve a small model with batched requests: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        [--arch tinyllama-1.1b] [--device cuda|cuda:i|cpu] [--ranks G]
        [--backend nccl|gloo]

The twin of examples/serve_decode.py: the arch's reduced config in
float32, weights drawn from a seeded `torch.Generator` on the device,
prompts drawn with numpy from a seed (a vlm's patch embeddings and an
encdec's frames from a generator seeded 1), greedy decode through
serve/engine.generate. Every arch runs. `main(argv)` returns the run's
numbers.

With --ranks G (an MoE arch; or under torchrun) the model is served by
G ranks of one torch.distributed group with axes data 1 x model G
(launch/mesh.py): each holds E/G experts and the rest replicated, runs
generate on the same prompts, the prefill's sort dispatch over the
ranks and each decode step's dispatch summed over them (models/moe.py).
Every rank's tokens must be the same; rank 0's numbers are returned.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.kernels import u32
from repro_torch.launch.mesh import (init_rank_mesh, spawn_ranks,
                                     under_torchrun)
from repro_torch.models import api as mapi
from repro_torch.serve.engine import ServeConfig, generate


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="cuda (a rank's own card), cuda:i or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of a data 1 x model G mesh (spawned here "
                         "unless run under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of the ranks (default: nccl "
                         "on cuda, gloo on cpu)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if under_torchrun():
        with init_rank_mesh(_world(), backend=args.backend,
                            device=args.device,
                            axes={"data": 1, "model": _world()}) as mesh:
            return run(args, mesh)
    if args.ranks == 1:
        return run(args, None)
    return spawn_ranks(_rank_main, args.ranks, args)[0]


def _world() -> int:
    return int(os.environ["WORLD_SIZE"])


def _rank_main(rank: int, world: int, store_path: str, args) -> dict:
    with init_rank_mesh(world, backend=args.backend, device=args.device,
                        rank=rank, world=world, store_path=store_path,
                        axes={"data": 1, "model": world}) as mesh:
        return run(args, mesh)


def run(args, mesh) -> dict:
    """The run in one process (`mesh` None) or on one rank (rank 0
    prints)."""
    lead = mesh is None or mesh.rank == 0
    dev = u32.resolve_device(args.device) if mesh is None else mesh.device
    cfg = get(args.arch).reduced(dtype="float32", remat=False)
    if mesh is not None:
        if not cfg.is_moe:
            raise ValueError(f"serve_decode --ranks: {args.arch} has no "
                             "experts to place on ranks")
        cfg = dataclasses.replace(cfg, dispatch_impl="sort")
    model = mapi.build(cfg, mesh=mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(prompt).to(dev),
             **mapi.stub_inputs(cfg, args.batch, args.prompt_len,
                                torch.Generator(device=dev).manual_seed(1))}

    t0 = time.perf_counter()
    out, steps = generate(model, params, batch,
                          ServeConfig(max_new_tokens=args.new_tokens))
    out = out.cpu()
    dt = time.perf_counter() - t0
    if mesh is not None:
        every = mesh.all_gather_object(out)
        if any(not torch.equal(t, out) for t in every):
            raise RuntimeError("serve_decode: the ranks generated different "
                               "tokens")
    if lead:
        print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
              f"new={steps} device={dev}"
              + ("" if mesh is None else f" on {mesh.world} ranks"))
        print(f"decoded {args.batch * steps} tokens in {dt:.2f}s "
              f"({args.batch * steps / dt:,.0f} tok/s)")
        print("sample token ids:", out[0, :16].tolist())
    return {"arch": args.arch, "tokens": out, "steps": steps, "seconds": dt,
            "tokens_per_s": args.batch * steps / dt,
            "ranks": 1 if mesh is None else mesh.world}


if __name__ == "__main__":
    main()
