"""End-to-end serving driver.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --batch 4 --prompt-len 32 --max-new 16 [--device cuda|cpu]

Twin of src/repro/launch/serve.py for every arch, with the same flags
plus --device (default the card; raises without one): config -> model
(weights and prompts drawn from torch.Generators seeded --seed and
--seed + 1 on the device; a vlm's patch embeddings and an encdec's
frames from the second, as the reference draws them) -> batched prefill
-> greedy or temperature decode with a KV cache (serve/engine.py),
printing tokens/s. `--reduced` uses the smoke-scale config.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.kernels import u32
from repro_torch.models import api as mapi
from repro_torch.serve.engine import ServeConfig, generate


def main(argv=None):
    """Returns {"tokens": (batch, max_new) int32 on the device, "steps",
    "seconds", "tokens_per_s"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-sized)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = u32.resolve_device(args.device)
    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced(dtype="float32", remat=False)
    model = mapi.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev),
             **mapi.stub_inputs(cfg, args.batch, args.prompt_len, gen)}

    scfg = ServeConfig(max_new_tokens=args.max_new,
                       temperature=args.temperature)
    t0 = time.perf_counter()
    out, steps = generate(model, params, batch, scfg, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = int(steps) * args.batch
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={int(steps)}  {dt:.2f}s  {toks / dt:.1f} tok/s")
    print("first sequence:", out[0].tolist())
    return {"tokens": out, "steps": int(steps), "seconds": dt,
            "tokens_per_s": toks / dt}


if __name__ == "__main__":
    main()
