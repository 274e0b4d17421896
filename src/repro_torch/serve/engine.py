"""Batched serving engine: prefill once, decode with a KV cache.

Twin of src/repro/serve/engine.py: static-shape batched decode, greedy or
temperature sampling (from an explicit `torch.Generator`), per-sequence
stop handling via an alive mask. The cache reserves the prompt, every
new token and one more position, as the reference does. Used by
repro_torch.examples.serve_decode and chip_smoke's serve phases.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models.api import ModelApi


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1: never stop early


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: ModelApi, params, batch, cfg: ServeConfig, *,
             generator: torch.Generator | None = None,
             stats: dict | None = None):
    """batch: the prefill inputs ({"tokens": (B, S) int on the params'
    device}). Returns (generated (B, max_new_tokens) int32, steps
    executed).

    `generator` draws the samples when temperature > 0 (default: one on
    the params' device seeded 0). Given a dict `stats`, the device is
    synchronised after the prefill and after each decode step, and
    `stats` gets "prefill_s" and "decode_s" (one wall time a step).
    """
    prompt = batch["tokens"]
    b, s = prompt.shape
    dev = prompt.device
    prefix = model.cfg.vlm_prefix if model.cfg.family == "vlm" else 0
    max_len = s + prefix + cfg.max_new_tokens + 1
    if generator is None and cfg.temperature > 0:
        generator = torch.Generator(device=dev).manual_seed(0)

    def sample(lg):
        lg = lg[:, -1]
        if cfg.temperature > 0:
            probs = torch.softmax(lg / cfg.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(lg, dim=-1)

    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, max_len=max_len)
    nxt = sample(logits).to(torch.int32)
    if stats is not None:
        _sync(dev)
        stats["prefill_s"] = time.perf_counter() - t0
        stats["decode_s"] = []
    toks = []
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    pos = s + prefix
    for _ in range(cfg.max_new_tokens):
        t0 = time.perf_counter()
        nxt = torch.where(alive, nxt, 0)
        toks.append(nxt)
        if cfg.eos_id >= 0:
            alive = alive & (nxt != cfg.eos_id)
        logits, cache = model.decode_step(params, cache, nxt[:, None], pos)
        nxt = sample(logits).to(torch.int32)
        pos += 1
        if stats is not None:
            _sync(dev)
            stats["decode_s"].append(time.perf_counter() - t0)
    return torch.stack(toks, dim=1), cfg.max_new_tokens
