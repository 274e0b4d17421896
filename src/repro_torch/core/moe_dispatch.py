"""MoE token->expert dispatch as an exoshuffle, over ranks or with the mesh
as a batch axis.

Twin of src/repro/core/moe_dispatch.py. Token routing in expert-parallel
MoE *is* the paper's shuffle with expert-id as the sort key: map (sort
tokens by expert), partition (experts are range-owned by EP shards),
shuffle (all_to_all), merge (group per local expert), compute, and an
inverse shuffle home. Two implementations:

  - "sort"   : that pipeline. The reference runs it per device under
               shard_map over a (data, model) mesh. Here it runs in one
               of two forms:
                 * per rank (`sort_dispatch_ranks`, the reference's
                   sort_dispatch_shard): a rank of a launch/mesh.RankMesh
                   holds its own tokens and only its E/ep experts, and
                   the tiled all_to_all runs over its "model" subgroup
                   (core/collectives.py);
                 * as a batch axis (`sort_dispatch`): the dp x ep shards
                   are one leading batch axis of every tensor in one
                   process, the all_to_all a transpose of the (ep_src,
                   ep_dst) axes, and ep_size=1 the single-card path (the
                   exchange is the identity). This form is the rank
                   form's oracle in the tests.
               Both run one pipeline (`_pipeline`): only the exchange,
               the owner of each shard's experts and the experts held
               differ.
  - "onehot" : GShard/Switch-style dense dispatch einsums with a (T, E, C)
               one-hot tensor — the classical baseline.

The decode dispatch (`ep_replicated_ranks`, `ep_replicated`) replicates
the few decode tokens over the EP shards instead and sums the partial
outputs (the reference's psum over "model").

Both drop tokens over expert capacity (standard capacity-factor semantics).

No hand-written kernel: the reference sorts with XLA's `jax.lax.sort`
and splits with `jnp.searchsorted`, outside any Pallas kernel, so their
counterparts here are `torch.sort(stable=True)` (lax.sort with one key
is stable) and `torch.searchsorted` (side="left"). Expert ids ride int64
carriers, so the reference's uint32 sentinels (expert E, slot
0xFFFFFFFF) compare as plain integers.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_to_all_tiled, psum, psum_grad


@dataclasses.dataclass(frozen=True)
class MoeDispatchConfig:
    num_experts: int  # routed experts E (global)
    top_k: int
    capacity_factor: float = 1.25


def route_topk(gate_logits: torch.Tensor, top_k: int):
    """Softmax-then-topk router. gate_logits (..., T, E).

    Returns (weights (..., T, K) float32 normalized over K, ids (..., T, K)
    int64). `torch.topk` may order exact ties differently from
    `lax.top_k` (lower index first); nothing else differs.
    """
    probs = torch.softmax(gate_logits.float(), dim=-1)
    weights, ids = torch.topk(probs, top_k, dim=-1)
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids


def _round_up(x: float, m: int) -> int:
    return int(math.ceil(x / m) * m)


# ---------------------------------------------------------------------------
# "onehot" baseline (GShard-style)
# ---------------------------------------------------------------------------


def onehot_dispatch_combine(x, weights, ids, *, num_experts: int,
                            capacity: int, expert_fn):
    """x (T, d); weights/ids (T, K). Returns (T, d_out).

    expert_fn: (E, C, d) -> (E, C, d_out), batched over experts.
    """
    t = x.shape[0]
    k = ids.shape[-1]
    dt = x.dtype
    # Position of each (token, k) inside its expert queue, k-major priority.
    onehot = F.one_hot(ids, num_experts)  # (T, K, E) int64
    flat = onehot.reshape(t * k, num_experts)
    pos = torch.cumsum(flat, dim=0) - flat  # (T*K, E) position if routed
    pos = (pos * flat).sum(dim=-1).reshape(t, k)  # (T, K)
    keep = pos < capacity
    w = weights * keep.to(weights.dtype)
    # dispatch (T, E, C) one-hot; a dropped pair's row is all zeros (the
    # reference's one_hot of an out-of-range position).
    pos_oh = (F.one_hot(torch.where(keep, pos, 0), capacity).to(dt)
              * keep[..., None].to(dt))
    oh = onehot.to(dt)
    disp = torch.einsum("tke,tkc->tec", oh, pos_oh)
    expert_in = torch.einsum("tec,td->ecd", disp, x)  # (E, C, d)
    expert_out = expert_fn(expert_in)
    # combine: each (t,k) takes expert_out[id_k, pos_k] weighted by w[t,k].
    gathered = torch.einsum("tkc,ecd,tke->tkd", pos_oh, expert_out, oh)
    return (gathered * w[..., None].to(gathered.dtype)).sum(dim=1)


# ---------------------------------------------------------------------------
# "sort" implementation (the exoshuffle pipeline)
# ---------------------------------------------------------------------------


def _all_to_all(t: torch.Tensor, dp: int, ep: int) -> torch.Tensor:
    """The tiled all_to_all over the EP axis: t (dp*ep, ep, ...) with
    t[(g, src), dst] the block src sends dst -> t'[(g, dst), src]."""
    rest = t.shape[2:]
    return (t.reshape(dp, ep, ep, *rest).transpose(1, 2)
            .reshape(dp * ep, ep, *rest))


def _pipeline(x, weights, ids, expert_params, *, cfg: MoeDispatchConfig,
              expert_fn, ep: int, s: int, banks: int, exchange, first,
              routing: dict | None):
    """The exoshuffle dispatch of the `s` shards this process holds.

    map:       sort each shard's (expert_id, slot) pairs by expert id
    partition: count pairs per owner shard (searchsorted at shard bounds)
    shuffle:   exchange fixed-capacity activation blocks over the EP axis
    merge:     regroup arrivals per local expert (second small sort)
    reduce:    batched expert FFN; then the whole pipeline reverses.

    x: (T, d), shard i holding rows [i*t, (i+1)*t), t = T / s; ep: EP
    shards in all; `exchange(blocks, what)` is the tiled all_to_all of
    (s, ep, cap, ...) blocks; `first` (s,) int64 is the first expert id
    of each shard's own bank; expert_params' leaves hold the banks of
    `banks` EP shards (ep in one process, 1 on a rank): leading axis
    banks * E/ep. Capacities come from the shard's t. `routing`, a dict,
    receives the routing: cap, ecap and (s, ...) send_e, recv_e, keep,
    rank.
    """
    n_tok, d = x.shape
    k = ids.shape[-1]
    e = cfg.num_experts
    e_local = e // ep
    t = n_tok // s
    if t * s != n_tok or e_local * ep != e:
        raise ValueError(f"T={n_tok} tokens over {s} shards and E={e} "
                         f"experts over ep={ep} must divide evenly")
    tk = t * k
    dev = x.device
    xs = x.reshape(s, t, d)
    flat_w = weights.reshape(s, tk)

    # --- map: sort (expert, slot) pairs by expert id ------------------------
    se, sslot = torch.sort(ids.reshape(s, tk).long(), dim=-1, stable=True)

    # --- partition at EP shard boundaries -----------------------------------
    bounds = torch.arange(1, ep, device=dev) * e_local
    starts = torch.searchsorted(se, bounds.expand(s, ep - 1).contiguous(),
                                side="left")
    zero = torch.zeros((s, 1), dtype=torch.int64, device=dev)
    starts = torch.cat([zero, starts], dim=-1)  # (S, ep)
    ends = torch.cat([starts[:, 1:], zero + tk], dim=-1)
    counts = ends - starts

    cap = _round_up(tk / ep * cfg.capacity_factor, 8)
    c = torch.arange(cap, device=dev)
    src = (starts[..., None] + c).clamp(0, tk - 1).reshape(s, ep * cap)
    valid = (c < counts[..., None]).reshape(s, ep * cap)

    send_e = torch.where(valid, se.gather(1, src), e)  # sentinel expert = E
    # A pad slot is the reference's 0xFFFFFFFF, clipped to slot tk-1.
    slot_clip = torch.where(valid, sslot.gather(1, src), tk - 1)
    send_tok = slot_clip // k  # (S, ep*cap) source token of each pair
    send_x = torch.where(
        valid[..., None],
        xs.gather(1, send_tok[..., None].expand(-1, -1, d)), 0)
    send_w = torch.where(valid, flat_w.gather(1, slot_clip), 0.0)

    # --- shuffle -------------------------------------------------------------
    recv_e = exchange(send_e.reshape(s, ep, cap), "moe.ids")
    recv_x = exchange(send_x.reshape(s, ep, cap, d), "moe.x")

    # --- merge: regroup arrivals per local expert ----------------------------
    m = ep * cap
    ge, gperm = torch.sort(recv_e.reshape(s, m), dim=-1, stable=True)
    rx = recv_x.reshape(s, m, d)
    local_bounds = first[:, None] + torch.arange(e_local, device=dev)
    estarts = torch.searchsorted(ge, local_bounds, side="left")
    # rank of each sorted arrival within its expert queue
    local_eid = (ge - first[:, None]).clamp(0, e_local - 1)
    rank = torch.arange(m, device=dev) - estarts.gather(1, local_eid)

    # Mean pairs per local expert is tk/e_local (every shard receives ~tk
    # pairs back); the capacity factor absorbs routing imbalance.
    ecap = max(_round_up(tk / e_local * cfg.capacity_factor, 8), 8)
    keep = (rank < ecap) & (ge < e)  # drop overflow + sentinels
    if routing is not None:
        routing.update(cap=cap, ecap=ecap, send_e=send_e,
                       recv_e=recv_e.reshape(s, m), keep=keep, rank=rank)

    # Scatter the arrivals into (S, E_local, ecap + 1, d). The reference
    # gives dropped pairs the out-of-range rank ecap and lets mode="drop"
    # discard them; here rank ecap is a real dump row that every dropped
    # pair lands on and that is sliced off before the experts run. Kept
    # pairs have distinct (expert, rank) slots below it. The index has a
    # fixed shape, so nothing waits for the card (a boolean mask would
    # sync on its count) and the dispatch runs on "meta" tensors.
    exp_in = torch.zeros((s, e_local, ecap + 1, d), dtype=x.dtype,
                         device=dev)
    shard = torch.arange(s, device=dev)[:, None].expand(s, m)
    arrived = rx.gather(1, gperm[..., None].expand(-1, -1, d))
    exp_in[shard, local_eid, torch.where(keep, rank, ecap)] = arrived
    exp_in = exp_in[:, :, :ecap]

    # --- reduce: one batched expert computation over the banks held -------
    rows = s // banks
    grid = exp_in.reshape(rows, banks, e_local, ecap, d).permute(1, 2, 0, 3, 4)
    exp_out = expert_fn(expert_params,
                        grid.reshape(banks * e_local, rows * ecap, d))
    d_out = exp_out.shape[-1]
    exp_out = (exp_out.reshape(banks, e_local, rows, ecap, d_out)
               .permute(2, 0, 1, 3, 4).reshape(s, e_local * ecap, d_out))

    # --- inverse pipeline -----------------------------------------------------
    sel = local_eid * ecap + torch.where(keep, rank, 0)
    y_sorted = torch.where(
        keep[..., None],
        exp_out.gather(1, sel[..., None].expand(-1, -1, d_out)), 0)
    # back to arrival order: gperm is a permutation of each row
    y_arrival = torch.empty_like(y_sorted).scatter_(
        1, gperm[..., None].expand(-1, -1, d_out), y_sorted)
    y_back = exchange(y_arrival.reshape(s, ep, cap, d_out), "moe.y")

    # combine at source: out[tok] += w * y for each of a shard's sent pairs.
    # index_add_ adds with atomics on a card: the order of the K adds to
    # one token, and so the last bits of the sum, may vary run to run.
    y_flat = y_back.reshape(s, m, d_out)
    w_flat = send_w[..., None].to(y_flat.dtype)
    tok = (torch.arange(s, device=dev)[:, None] * t + send_tok).reshape(-1)
    out = torch.zeros((n_tok, d_out), dtype=y_flat.dtype, device=dev)
    return out.index_add_(0, tok, (y_flat * w_flat).reshape(-1, d_out))


def sort_dispatch(x, weights, ids, expert_params, *, cfg: MoeDispatchConfig,
                  expert_fn, ep_size: int = 1, dp: int = 1,
                  routing: dict | None = None):
    """The exoshuffle dispatch for all dp x ep_size shards at once, in one
    process (the batch-axis form).

    x: (T, d) tokens, shard (g, j) holding rows [(g*ep + j)*t, +t) with
    t = T / (dp*ep) — the reference's P(("data", "model")) layout;
    weights/ids: (T, K); expert_params: pytree whose leaves have leading
    axis E (all experts; EP shard j owns [j*E_local, (j+1)*E_local)).
    expert_fn(params, xin) maps (E, C, d) -> (E, C, d_out). Returns
    (T, d_out), in x's dtype. `routing`: see _pipeline.
    """
    ep = ep_size
    s = dp * ep
    e_local = cfg.num_experts // max(ep, 1)
    first = (torch.arange(s, device=x.device) % ep) * e_local
    return _pipeline(x, weights, ids, expert_params, cfg=cfg,
                     expert_fn=expert_fn, ep=ep, s=s, banks=ep,
                     exchange=lambda blocks, what: _all_to_all(blocks, dp, ep),
                     first=first, routing=routing)


def sort_dispatch_ranks(x, weights, ids, expert_params, *,
                        cfg: MoeDispatchConfig, expert_fn, mesh,
                        routing: dict | None = None):
    """The exoshuffle dispatch on one rank of `mesh` (the reference's
    sort_dispatch_shard under shard_map).

    x: (t, d) this rank's tokens; weights/ids: (t, K); expert_params:
    this rank's bank, leading axis E/ep, where ep = mesh.size_of("model")
    and the rank at index j of "model" owns experts [j*E/ep, (j+1)*E/ep)
    (`first` is index_of("model"), the reference's axis_index). The tiled
    all_to_all runs over the rank's "model" subgroup, with gradients;
    capacities come from this rank's t. Returns (t, d_out).
    `routing`: see _pipeline (a leading axis of 1).
    """
    ep = mesh.size_of("model")
    e_local = cfg.num_experts // ep
    first = torch.full((1,), mesh.index_of("model") * e_local,
                       dtype=torch.int64, device=x.device)

    def exchange(blocks, what):
        if ep == 1:
            return blocks
        return all_to_all_tiled(blocks, mesh, what=what, axis="model")

    return _pipeline(x, weights, ids, expert_params, cfg=cfg,
                     expert_fn=expert_fn, ep=ep, s=1, banks=1,
                     exchange=exchange, first=first, routing=routing)


# ---------------------------------------------------------------------------
# decode-time EP dispatch: tokens replicated over the EP axis
# ---------------------------------------------------------------------------


def _expert_slice(params, lo: int, hi: int):
    """The experts [lo, hi) of a pytree of (E, ...) tensors."""
    if isinstance(params, dict):
        return {key: _expert_slice(v, lo, hi) for key, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_expert_slice(v, lo, hi) for v in params)
    return params[lo:hi]


def _local_experts(x, weights, ids, expert_params, *, lo: int, e_local: int,
                   expert_fn):
    """One EP shard's part of the decode dispatch: the routes to experts
    [lo, lo + e_local) through that bank (expert_params, leading axis
    e_local); the others are clipped into the local id range as weight-0
    "ghosts". Capacity = T*K makes every queue large enough that ghosts
    never displace a real token."""
    local = (ids >= lo) & (ids < lo + e_local)
    w_local = torch.where(local, weights, 0.0)
    ids_local = (ids - lo).clamp(0, e_local - 1)
    return onehot_dispatch_combine(
        x, w_local, ids_local, num_experts=e_local,
        capacity=x.shape[0] * ids.shape[-1],
        expert_fn=lambda xin: expert_fn(expert_params, xin))


def ep_replicated(x, weights, ids, expert_params, *, cfg: MoeDispatchConfig,
                  ep_size: int, expert_fn):
    """Decode dispatch with every token replicated over the EP axis, all
    ep_size shards in one process (the batch-axis form).

    At decode the token count (B) is far below the mesh size, so the
    all_to_all pipeline has nothing to shard. Instead every EP shard sees
    ALL tokens, masks the routing weights to the experts it owns, runs
    its local expert bank, and the partial outputs are summed over the
    EP axis (the reference's psum).

    x (T, d); weights/ids (T, K); expert_params: pytree with leading
    axis E. Returns (T, d_out).
    """
    e_local = cfg.num_experts // ep_size
    out = None
    for j in range(ep_size):
        lo = j * e_local
        part = _local_experts(
            x, weights, ids, _expert_slice(expert_params, lo, lo + e_local),
            lo=lo, e_local=e_local, expert_fn=expert_fn)
        out = part if out is None else out + part
    return out


def ep_replicated_ranks(x, weights, ids, expert_params, *,
                        cfg: MoeDispatchConfig, expert_fn, mesh,
                        reduce: bool = True):
    """The decode dispatch on one rank of `mesh` (the reference's
    ep_replicated_shard): x (T, d), weights/ids (T, K) the same on every
    rank of a "model" subgroup; expert_params this rank's E/ep experts.
    The rank runs its bank's part and the parts are summed over the
    subgroup (all_reduce: every rank gets the same bytes). Gradients: the
    tokens' and the routing weights' are summed over the subgroup too
    (each rank computes only its bank's part of them). Returns (T,
    d_out); with `reduce=False`, the rank's part unsummed (the caller
    adds other partial sums to it before its own psum)."""
    ep = mesh.size_of("model")
    e_local = cfg.num_experts // ep
    x = psum_grad(x, mesh, "model", what="moe.psum")
    weights = psum_grad(weights, mesh, "model", what="moe.psum")
    part = _local_experts(x, weights, ids, expert_params,
                          lo=mesh.index_of("model") * e_local,
                          e_local=e_local, expert_fn=expert_fn)
    return psum(part, mesh, "model", what="moe.psum") if reduce else part
