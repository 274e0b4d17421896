"""Serve a small model with batched requests: prefill + KV-cache decode.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        [--arch tinyllama-1.1b] [--device cuda|cpu]

The twin of examples/serve_decode.py: the arch's reduced config in
float32, weights drawn from a seeded `torch.Generator` on the device,
prompts drawn with numpy from a seed (a vlm's patch embeddings and an
encdec's frames from a generator seeded 1), greedy decode through
serve/engine.generate. Every arch runs. `main(argv)` returns the run's
numbers.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.kernels import u32
from repro_torch.models import api as mapi
from repro_torch.serve.engine import ServeConfig, generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=48)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = u32.resolve_device(args.device)
    cfg = get(args.arch).reduced(dtype="float32", remat=False)
    model = mapi.build(cfg)
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
    print(f"arch={args.arch} batch={args.batch} prompt={args.prompt_len} "
          f"new={steps} device={dev}")
    print(f"decoded {args.batch * steps} tokens in {dt:.2f}s "
          f"({args.batch * steps / dt:,.0f} tok/s)")
    print("sample token ids:", out[0, :16].tolist())
    return {"arch": args.arch, "tokens": out, "steps": steps, "seconds": dt,
            "tokens_per_s": args.batch * steps / dt}


if __name__ == "__main__":
    main()
