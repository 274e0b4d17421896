"""Serve a small model with batched requests: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        [--arch tinyllama-1.1b] [--device cuda|cuda:i|cpu] [--ranks G]
        [--mesh data=D,model=M] [--backend nccl|gloo]

The twin of examples/serve_decode.py: the arch's reduced config in
float32, weights drawn from a seeded `torch.Generator` on the device,
prompts drawn with numpy from a seed (a vlm's patch embeddings and an
encdec's frames from a generator seeded 1), greedy decode through
serve/engine.generate. Every arch runs. `main(argv)` returns the run's
numbers.

With --ranks G (or under torchrun with G ranks) the model is served by
G ranks of one torch.distributed group with axes data 1 x model G
(launch/mesh.py); --mesh data=D,model=M names another layout of D * M
ranks. A rank holds its slice of what launch/sharding.split_dims names:
for an `attn_sharding="heads"` arch, 1/M of every projection, FFN and
the tied vocabulary (tensor parallelism, models/transformer.py) and an
MoE's E/M experts, its dispatch over the ranks (models/moe.py); other
archs are replicated on a rank. A heads arch whose KV heads do not
divide M raises NotImplementedError (the reduced tinyllama-1.1b and
mistral-nemo-12b hold 2 KV heads: model 2 at most). Each data row
serves its rows of the batch; every rank's tokens, gathered, must be
the same on every rank; rank 0's numbers are returned.
"""
import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.kernels import u32
from repro_torch.launch.mesh import (init_rank_mesh, parse_axes,
                                     spawn_ranks, under_torchrun)
from repro_torch.launch.sharding import local_batch
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
    ap.add_argument("--mesh", type=parse_axes, default=None,
                    help="data=D,model=M: the ranks' layout (D * M ranks; "
                         "overrides --ranks)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of the ranks (default: nccl "
                         "on cuda, gloo on cpu)")
    return ap


def _axes(args, world: int | None = None) -> dict:
    """The ranks' layout: --mesh, else data 1 x model (--ranks, or the
    torchrun world)."""
    if args.mesh is not None:
        return args.mesh
    return {"data": 1, "model": world or args.ranks}


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        with init_rank_mesh(world, backend=args.backend, device=args.device,
                            axes=_axes(args, world)) as mesh:
            return run(args, mesh)
    world = math.prod(_axes(args).values())
    if world == 1:
        return run(args, None)
    return spawn_ranks(_rank_main, world, args)[0]


def _rank_main(rank: int, world: int, store_path: str, args) -> dict:
    with init_rank_mesh(world, backend=args.backend, device=args.device,
                        rank=rank, world=world, store_path=store_path,
                        axes=_axes(args)) as mesh:
        return run(args, mesh)


def run(args, mesh) -> dict:
    """The run in one process (`mesh` None) or on one rank (rank 0
    prints)."""
    lead = mesh is None or mesh.rank == 0
    dev = u32.resolve_device(args.device) if mesh is None else mesh.device
    cfg = get(args.arch).reduced(dtype="float32", remat=False)
    if mesh is not None and cfg.is_moe:
        cfg = dataclasses.replace(cfg, dispatch_impl="sort")
    model = mapi.build(cfg, mesh=mesh)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, (args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(prompt).to(dev),
             **mapi.stub_inputs(cfg, args.batch, args.prompt_len,
                                torch.Generator(device=dev).manual_seed(1))}
    if mesh is not None:
        batch = local_batch(batch, mesh)

    t0 = time.perf_counter()
    out, steps = generate(model, params, batch,
                          ServeConfig(max_new_tokens=args.new_tokens))
    out = out.cpu()
    dt = time.perf_counter() - t0
    if mesh is not None:
        every = mesh.all_gather_object(out)
        m = mesh.size_of("model")  # rank r = data row r // m
        if any(not torch.equal(every[r], every[r - r % m])
               for r in range(mesh.world)):
            raise RuntimeError("serve_decode: the ranks of a data row "
                               "generated different tokens")
        if out.shape[0] < args.batch:  # the data rows' tokens, in order
            out = torch.cat(every[::m])
    if lead:
        print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
              f"new={steps} device={dev}"
              + ("" if mesh is None else
                 f" on {mesh.world} ranks {dict(mesh.axes)}"))
        print(f"decoded {args.batch * steps} tokens in {dt:.2f}s "
              f"({args.batch * steps / dt:,.0f} tok/s)")
        print("sample token ids:", out[0, :16].tolist())
    return {"arch": args.arch, "tokens": out, "steps": steps, "seconds": dt,
            "tokens_per_s": args.batch * steps / dt,
            "ranks": 1 if mesh is None else mesh.world,
            "mesh": None if mesh is None else dict(mesh.axes)}


if __name__ == "__main__":
    main()
