"""Unified model API: build(cfg) -> ModelApi with the serving entry points.

Twin of src/repro/models/api.py for the `dense` and `moe` families; the
other families raise NotImplementedError naming the ROADMAP item that
ports them. Training (`loss`), the abstract shape specs, `init_cache`
and the benchmark shape cells serve the training and dry-run tooling,
which is not ported yet, and have no twin here (`prefill` makes the
cache).

`params` is a `transformer.Transformer` (an nn.Module holding the
weights): `init(generator)` draws them on the generator's device;
`params_from_reference(tree, device=...)` carries the JAX package's
parameter pytree (numpy arrays, block leaves stacked (L, ...)) across,
so that both packages compute from the same weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import u32
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]  # (generator) -> params
    forward: Callable[..., Any]  # (params, batch) -> logits
    prefill: Callable[..., Any]  # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any]  # (params, cache, token, pos) -> (logits, cache)
    params_from_reference: Callable[..., Any]  # (tree, device=) -> params


def params_from_reference(cfg: ArchConfig, tree, *, device="cuda"):
    """The port's model holding the reference's weights: `tree` is the
    JAX parameter pytree as nested dicts of numpy arrays (e.g.
    `jax.tree.map(np.asarray, params)`), cast to the config's dtype."""
    dev = u32.resolve_device(device)
    model = transformer.Transformer(cfg, None)  # shapes only, on "meta"
    state = {name: torch.from_numpy(np.array(arr)).to(
        device=dev, dtype=cfg.compute_dtype)
        for name, arr in transformer.reference_state(cfg, tree).items()}
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(False)


def build(cfg: ArchConfig) -> ModelApi:
    transformer.check_family(cfg)

    def init(generator: torch.Generator):
        return transformer.init_params(cfg, generator)

    def forward(params, batch):
        return params.forward(batch["tokens"])

    def prefill(params, batch, max_len=None):
        return params.prefill(batch["tokens"], max_len=max_len)

    def decode_step(params, cache, token, pos):
        return params.decode_step(cache, token, pos)

    def from_reference(tree, *, device="cuda"):
        return params_from_reference(cfg, tree, device=device)

    return ModelApi(cfg=cfg, init=init, forward=forward, prefill=prefill,
                    decode_step=decode_step,
                    params_from_reference=from_reference)
