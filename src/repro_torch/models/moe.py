"""Mixture-of-experts FFN block (qwen2-moe, moonshot) with exoshuffle dispatch.

Twin of src/repro/models/moe.py. `dispatch_impl` selects:

  sort   — on a mesh (ep_size * dp > 1), the exoshuffle dispatch with the
           dp x ep shards as a batch axis (core/moe_dispatch.sort_dispatch
           with ep_size, dp: the reference's shard_map branch), and at
           decode (one position) the replicated dispatch
           (`ep_replicated`); without one, the single-shard pipeline.
  onehot — the GShard dense-einsum baseline.
  dense  — the single-shard sort pipeline (the exchange is the identity).

Pad experts (n_experts_padded > n_experts) exist as parameters, but the
router never selects them: their logits are -inf before the softmax, so
the probabilities are taken over the real experts only and no gradient
reaches the pad router columns or the pad expert banks. (The reference
routes over every column; ROADMAP.md §3 fault 4.) A config without pads
computes exactly what it did before the mask.

Shared experts (qwen2-moe has 4, fused into one wide SwiGLU) run dense
alongside the routed path. Every dispatch path carries gradients into
the tokens, the routing weights and the expert banks.
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


def mask_pad_experts(logits, n_experts: int):
    """Router logits (T, E padded) with the pad columns (>= n_experts) at
    -inf; unchanged (the same tensor) when there are no pads."""
    e_pad = logits.shape[-1]
    if n_experts >= e_pad:
        return logits
    pad = torch.arange(e_pad, device=logits.device) >= n_experts
    return logits.masked_fill(pad, float("-inf"))


class MoeFFN(nn.Module):
    """Router, the routed expert bank (E padded, ...) and the shared
    experts of one block. `dtype` is the parameters' storage type."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, dtype: torch.dtype, requires_grad: bool = False):
        super().__init__()
        self.cfg = cfg
        d, e, fe = cfg.d_model, cfg.n_experts_padded, cfg.d_ff_expert

        def uni(shape, scale=None):
            return nn.Parameter(layers.uniform_init(shape, generator, scale,
                                                    dtype=dtype),
                                requires_grad=requires_grad)

        self.router = uni((d, e))
        self.w_gate = uni((e, d, fe), d**-0.5)
        self.w_up = uni((e, d, fe), d**-0.5)
        self.w_down = uni((e, fe, d), fe**-0.5)
        self.shared = (nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=requires_grad) for k, v in
             layers.swiglu_init(d, cfg.shared_d_ff, generator,
                                dtype).items()})
            if cfg.shared_d_ff else None)

    def experts(self):
        return {"w_gate": self.w_gate, "w_up": self.w_up,
                "w_down": self.w_down}

    def forward(self, x, *, ep_size: int = 1, dp: int = 1):
        """x (B, S, d) -> (B, S, d). ep_size, dp: the mesh as a batch axis
        (the reference's `mesh` with dp data shards x ep_size EP shards;
        both 1 for no mesh)."""
        cfg = self.cfg
        dt = x.dtype
        b, s, d = x.shape
        tokens = x.reshape(b * s, d)
        logits = mask_pad_experts(tokens @ self.router.to(dt), cfg.n_experts)
        weights, ids = md.route_topk(logits, cfg.top_k)
        impl = cfg.dispatch_impl
        mesh = ep_size * dp > 1
        dcfg = md.MoeDispatchConfig(
            num_experts=cfg.n_experts_padded, top_k=cfg.top_k,
            capacity_factor=cfg.moe_capacity_factor)
        if impl == "sort" and mesh and s == 1:
            # decode: tokens (B) << mesh size, replicated over the EP shards
            routed = md.ep_replicated(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, ep_size=ep_size,
                                      expert_fn=expert_fn)
        elif impl == "sort" and mesh:
            routed = md.sort_dispatch(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, expert_fn=expert_fn,
                                      ep_size=ep_size, dp=dp)
        elif impl == "onehot":
            cap = md._round_up(
                tokens.shape[0] * cfg.top_k / cfg.n_experts
                * cfg.moe_capacity_factor, 8)
            routed = md.onehot_dispatch_combine(
                tokens, weights, ids, num_experts=cfg.n_experts_padded,
                capacity=cap,
                expert_fn=lambda xin: expert_fn(self.experts(), xin))
        else:  # dense, or sort without a mesh: the single-shard pipeline
            routed = md.sort_dispatch(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, expert_fn=expert_fn)
        out = routed.reshape(b, s, d).to(dt)
        if self.shared is not None:
            out = out + layers.swiglu(self.shared, x)
        return out
