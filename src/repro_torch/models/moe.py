"""Mixture-of-experts FFN block (qwen2-moe, moonshot) with exoshuffle dispatch.

Twin of src/repro/models/moe.py on one card. `dispatch_impl` selects:

  sort, dense — the exoshuffle sort pipeline on one shard (ep_size=1,
                the exchange is the identity): the reference's `mesh=None`
                branch, which is what one card runs.
  onehot      — the GShard dense-einsum baseline.

The reference's mesh branches (EP all_to_all under shard_map, and the
replicated decode dispatch) have their twin in core/moe_dispatch
(`sort_dispatch(..., ep_size, dp)`, `ep_replicated`) with the shards as
a batch axis. Shared experts (qwen2-moe has 4, fused into one wide
SwiGLU) run dense alongside the routed path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import moe_dispatch as md
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def expert_fn(params, xin):
    """Batched SwiGLU experts. params: (E, ...) tensors; xin (E, C, d)."""
    dt = xin.dtype
    g = torch.bmm(xin, params["w_gate"].to(dt))
    u = torch.bmm(xin, params["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, params["w_down"].to(dt))


class MoeFFN(nn.Module):
    """Router, the routed expert bank (E padded, ...) and the shared
    experts of one block."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, e, fe = cfg.d_model, cfg.n_experts_padded, cfg.d_ff_expert
        dt = cfg.compute_dtype

        def uni(shape, scale=None):
            return nn.Parameter(layers.uniform_init(shape, generator, scale,
                                                    dtype=dt),
                                requires_grad=False)

        self.router = uni((d, e))
        self.w_gate = uni((e, d, fe), d**-0.5)
        self.w_up = uni((e, d, fe), d**-0.5)
        self.w_down = uni((e, fe, d), fe**-0.5)
        self.shared = (nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in
             layers.swiglu_init(d, cfg.shared_d_ff, generator, dt).items()})
            if cfg.shared_d_ff else None)

    def experts(self):
        return {"w_gate": self.w_gate, "w_up": self.w_up,
                "w_down": self.w_down}

    def forward(self, x):
        """x (B, S, d) -> (B, S, d)."""
        cfg = self.cfg
        dt = x.dtype
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        logits = tokens @ self.router.to(dt)
        weights, ids = md.route_topk(logits, cfg.top_k)
        if cfg.dispatch_impl == "onehot":
            cap = md._round_up(
                tokens.shape[0] * cfg.top_k / cfg.n_experts
                * cfg.moe_capacity_factor, 8)
            routed = md.onehot_dispatch_combine(
                tokens, weights, ids, num_experts=cfg.n_experts_padded,
                capacity=cap,
                expert_fn=lambda xin: expert_fn(self.experts(), xin))
        else:  # sort / dense: the single-shard sort pipeline
            dcfg = md.MoeDispatchConfig(
                num_experts=cfg.n_experts_padded, top_k=cfg.top_k,
                capacity_factor=cfg.moe_capacity_factor)
            routed = md.sort_dispatch(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, expert_fn=expert_fn)
        out = routed.reshape(b, s, d).to(dt)
        if self.shared is not None:
            out = out + layers.swiglu(self.shared, x)
        return out
