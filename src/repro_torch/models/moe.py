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

On a rank of a launch/mesh.RankMesh (`mesh=`), the block holds only its
E/ep experts, ep = the "model" axis's size (launch/sharding's EP rule),
and, for an `attn_sharding="heads"` config, 1/tp of the shared experts'
width (TP, tp = ep: w_gate and w_up column-parallel, w_down
row-parallel): it still draws every tensor in the one-process order and
keeps its slice, so that its weights equal the one-process model's
(transiently one whole expert bank). `forward` then takes the
reference's two shard_map branches with the sort dispatch: over the
ranks (`sort_dispatch_ranks`) for S > 1, the tokens of the rank's data
row split over "model" and, back, each rank's rows placed in the whole;
replicated (`ep_replicated_ranks`) for S == 1, each rank's experts'
part. Either way the routed output of the rank is a partial sum that
joins the shared experts' partial sum before one psum over "model"
(shared experts that are not split are added after it). The router
runs replicated on every rank of the row, on the same bytes, so routing
is what the one-process block's is; the block's input and output are
replicated over "model".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import moe_dispatch as md
from repro_torch.core.collectives import psum, split_rows
from repro_torch.launch.sharding import split_of
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


def expert_range(cfg: ArchConfig, mesh) -> tuple[int, int]:
    """[lo, hi) of the (padded) experts a rank of `mesh` holds: all of
    them without a mesh."""
    e = cfg.n_experts_padded
    ep = 1 if mesh is None else mesh.size_of("model")
    if e % ep:
        raise ValueError(f"{cfg.name}: {e} experts do not split over "
                         f"{ep} ranks of 'model'")
    j = 0 if mesh is None else mesh.index_of("model")
    return j * e // ep, (j + 1) * e // ep


class MoeFFN(nn.Module):
    """Router, the routed expert bank (E padded, ...) and the shared
    experts of one block. `dtype` is the parameters' storage type; on a
    rank of `mesh`, the bank holds the rank's experts only."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, dtype: torch.dtype, requires_grad: bool = False,
                 mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        d, e, fe = cfg.d_model, cfg.n_experts_padded, cfg.d_ff_expert
        expert_range(cfg, mesh)  # the bank splits evenly, or raise
        #: {state name: dim} of this block's tensors split over the ranks
        #: (launch/sharding.split_of)
        self.placement = split_of(cfg, mesh, "blocks.0.ffn.")
        #: the rank's mesh when the shared experts are tensor-parallel
        self.tp = mesh if "shared.w_down" in self.placement else None

        def uni(name, shape, scale=None):
            t = layers.uniform_init(shape, generator, scale, dtype=dtype)
            # the whole tensor's draw, then the rank's slice
            t = layers.placed({name: t}, self.placement, "", mesh)[name]
            return nn.Parameter(t, requires_grad=requires_grad)

        self.router = uni("router", (d, e))
        self.w_gate = uni("w_gate", (e, d, fe), d**-0.5)
        self.w_up = uni("w_up", (e, d, fe), d**-0.5)
        self.w_down = uni("w_down", (e, fe, d), fe**-0.5)
        self.shared = (nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=requires_grad) for k, v in
             layers.placed(layers.swiglu_init(d, cfg.shared_d_ff, generator,
                                              dtype), self.placement,
                           "shared.", mesh).items()})
            if cfg.shared_d_ff else None)

    def experts(self):
        return {"w_gate": self.w_gate, "w_up": self.w_up,
                "w_down": self.w_down}

    def forward(self, x, *, ep_size: int = 1, dp: int = 1,
                routing: dict | None = None):
        """x (B, S, d) -> (B, S, d). ep_size, dp: the mesh as a batch axis
        (the reference's `mesh` with dp data shards x ep_size EP shards;
        both 1 for no mesh). On a rank (the block's `mesh`), x is the
        rank's data row and both stay 1. `routing`: a dict that the sort
        dispatch fills with its routing record (core/moe_dispatch)."""
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
        banks = "w_gate" in self.placement
        if self.mesh is not None and (mesh or (impl != "sort" and banks)):
            raise ValueError(f"{cfg.name}: a rank's MoE block runs the sort "
                             "dispatch over its mesh (dispatch_impl="
                             f"{impl!r}, ep_size={ep_size}, dp={dp})")
        if self.mesh is not None and impl == "sort":
            routed = self._ranks(tokens, weights, ids, dcfg, s, routing)
        elif impl == "sort" and mesh and s == 1:
            # decode: tokens (B) << mesh size, replicated over the EP shards
            routed = md.ep_replicated(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, ep_size=ep_size,
                                      expert_fn=expert_fn)
        elif impl == "sort" and mesh:
            routed = md.sort_dispatch(tokens, weights, ids, self.experts(),
                                      cfg=dcfg, expert_fn=expert_fn,
                                      ep_size=ep_size, dp=dp, routing=routing)
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
                                      cfg=dcfg, expert_fn=expert_fn,
                                      routing=routing)
        out = routed.reshape(b, s, d).to(dt)
        shared = self.shared is not None
        if self.tp is not None:  # TP shared experts: a partial sum too
            out = out + layers.swiglu(self.shared, x, mesh=self.tp,
                                      reduce=False)
            shared = False
        if self.mesh is not None and impl == "sort":
            # the rank's partial sums, summed over "model" in one psum
            out = psum(out, self.mesh, "model", what="moe.psum")
        if shared:
            out = out + layers.swiglu(self.shared, x)
        return out

    def _ranks(self, tokens, weights, ids, dcfg, s, routing):
        """The dispatch over the block's mesh: the rank's row of tokens
        (T, d), replicated over "model", in; out, the rank's part of the
        routed output (T, d), which forward sums over "model": its rows
        in place and zeros elsewhere (S > 1), its experts' part
        (decode)."""
        mesh = self.mesh
        if s == 1:
            # decode: tokens (B) << mesh size, replicated over the EP ranks
            return md.ep_replicated_ranks(tokens, weights, ids,
                                          self.experts(), cfg=dcfg,
                                          expert_fn=expert_fn, mesh=mesh,
                                          reduce=False)
        ep, j = mesh.size_of("model"), mesh.index_of("model")
        t = tokens.shape[0] // ep
        if t * ep != tokens.shape[0]:
            raise ValueError(f"{tokens.shape[0]} tokens of a data row do "
                             f"not split over {ep} ranks of 'model'")
        mine = md.sort_dispatch_ranks(
            split_rows(tokens, mesh, "model"),
            split_rows(weights, mesh, "model"), ids[j * t:(j + 1) * t],
            self.experts(), cfg=dcfg, expert_fn=expert_fn, mesh=mesh,
            routing=routing)
        # backward: this rank's rows of the gradient, unsummed
        return F.pad(mine, (0, 0, j * t, (ep - 1 - j) * t))
