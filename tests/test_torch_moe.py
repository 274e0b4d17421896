"""The port's MoE dispatch (core/moe_dispatch.py) against the JAX package.

The sort dispatch runs the dp x ep mesh shards as one batch axis and the
all_to_all as a transpose; the JAX package runs `make_sort_dispatch` and
`ep_replicated_shard` under shard_map, jit-compiled, on host meshes, in
one module-scoped subprocess (tests/helpers.run_with_devices). The
single-shard paths (route_topk, the onehot baseline, the sort pipeline
at ep_size=1, the model's MoE FFN) run the JAX functions in-process.
Inputs are drawn with numpy from a seed. Bounds are the reference tests'
own (tests/test_exoshuffle.py): 1e-4 for the sort dispatch, 2e-5 for the
decode dispatch.

The port's router never selects a pad expert (column >= n_experts of a
config whose expert count is padded to 16); the reference's does
(ROADMAP.md §3, fault 4). So a comparison on a config with pads holds
the port against the reference with its `route_topk` wrapped to mask the
pad columns to -inf first (`masked_reference_router`; the reference's
moe_ffn calls it as `md.route_topk`, and every JAX trace of such a
comparison is made inside the wrapper). The reference itself is not
edited.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.core import moe_dispatch as jmd
from repro.models import moe as jmoe
from repro_torch.core import moe_dispatch as tmd
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

# name: (mesh (dp, ep), E, K, d, d_ff, T, capacity_factor)
SORTS = {
    "dp2_ep4": ((2, 4), 16, 2, 32, 64, 512, 4.0),
    "dp2_ep4_drops": ((2, 4), 16, 2, 32, 64, 512, 1.0),
    "dp1_ep8": ((1, 8), 16, 4, 32, 64, 256, 1.25),
}
# the decode dispatch: mesh (2, 4), E, K, T, d, d_ff
DECODE = (8, 2, 16, 32, 64)


def masked_route_topk(route_topk, n_experts: int):
    """`route_topk` with the router columns >= n_experts at -inf."""
    def masked(gate_logits, top_k):
        col = jnp.arange(gate_logits.shape[-1])
        return route_topk(jnp.where(col >= n_experts, -jnp.inf, gate_logits),
                          top_k)
    return masked


@contextlib.contextmanager
def masked_reference_router(cfg):
    """The reference routing as the config's contract says: inside, the
    JAX package's route_topk masks the pad experts of `cfg` (a no-op for
    a config without pads)."""
    orig = jmd.route_topk
    if cfg.n_experts < cfg.n_experts_padded:
        jmd.route_topk = masked_route_topk(orig, cfg.n_experts)
    try:
        yield
    finally:
        jmd.route_topk = orig


#: The same wrapper for a JAX run in a run_with_devices subprocess, to be
#: executed before its first trace: `.format(n_experts=...)`.
MASKED_ROUTER_SRC = """
import jax.numpy as _jnp
from repro.core import moe_dispatch as _md
_route_topk = _md.route_topk
def _masked_route_topk(gate_logits, top_k):
    col = _jnp.arange(gate_logits.shape[-1])
    return _route_topk(_jnp.where(col >= {n_experts}, -_jnp.inf, gate_logits),
                       top_k)
_md.route_topk = _masked_route_topk
"""


def _inputs(e, k, d, f, t, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(t, d)).astype(np.float32),
        logits=rng.normal(size=(t, e)).astype(np.float32),
        w_gate=(rng.normal(size=(e, d, f)) * 0.1).astype(np.float32),
        w_up=(rng.normal(size=(e, d, f)) * 0.1).astype(np.float32),
        w_down=(rng.normal(size=(e, f, d)) * 0.1).astype(np.float32))


def _experts(inp, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return {n: conv(inp[n]) for n in ("w_gate", "w_up", "w_down")}


_JAX = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import compat
from repro.core import moe_dispatch as md
from repro.models.moe import _expert_fn

inp = dict(np.load({inp!r}))
out = {{}}
for name, (mesh_shape, e, k, d, f, t, cf) in json.loads({sorts!r}).items():
    mesh = compat.make_mesh(tuple(mesh_shape), ("data", "model"))
    x = jnp.asarray(inp[name + "_x"])
    w, ids = md.route_topk(jnp.asarray(inp[name + "_logits"]), k)
    prm = {{n: jnp.asarray(inp[name + "_" + n])
           for n in ("w_gate", "w_up", "w_down")}}
    cfg = md.MoeDispatchConfig(num_experts=e, top_k=k, capacity_factor=cf)
    fn = md.make_sort_dispatch(
        mesh, cfg, _expert_fn, token_spec=P(("data", "model"), None),
        param_spec={{n: P("model", None, None) for n in prm}})
    out[name] = np.asarray(jax.jit(fn)(x, w, ids, prm))

e, k, t, d, f = {decode}
mesh = compat.make_mesh((2, 4), ("data", "model"))
x = jnp.asarray(inp["decode_x"])
w, ids = md.route_topk(jnp.asarray(inp["decode_logits"]), k)
prm = {{n: jnp.asarray(inp["decode_" + n])
       for n in ("w_gate", "w_up", "w_down")}}
cfg = md.MoeDispatchConfig(num_experts=e, top_k=k, ep_axis="model")
fn = compat.shard_map(
    lambda tk, ww, ii, ep: md.ep_replicated_shard(
        tk, ww, ii, ep, cfg=cfg, ep_size=4, expert_fn=_expert_fn),
    mesh=mesh,
    in_specs=(P("data", None), P("data", None), P("data", None),
              {{n: P("model", None, None) for n in prm}}),
    out_specs=P("data", None), check_vma=False)
out["decode"] = np.asarray(jax.jit(fn)(x, w, ids, prm))
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_moe")
    arrays = {}
    for name, (_, e, k, dm, f, t, _) in SORTS.items():
        for key, v in _inputs(e, k, dm, f, t).items():
            arrays[f"{name}_{key}"] = v
    e, k, t, dm, f = DECODE
    for key, v in _inputs(e, k, dm, f, t, seed=1).items():
        arrays[f"decode_{key}"] = v
    inp = str(d / "in.npz")
    np.savez(inp, **arrays)
    outp = str(d / "out.npz")
    run_with_devices(_JAX.format(inp=inp, sorts=json.dumps(SORTS),
                                 decode=DECODE, outp=outp))
    with np.load(outp) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# single-shard functions against the JAX functions in-process
# ---------------------------------------------------------------------------


def test_route_topk_matches_jax():
    logits = np.random.default_rng(3).normal(size=(64, 60)).astype(np.float32)
    jw, jids = jmd.route_topk(jnp.asarray(logits), 4)
    tw, tids = tmd.route_topk(torch.from_numpy(logits), 4)
    assert tids.dtype == torch.int64
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


def _single_shard_case(e=16, k=2, d=32, f=64, t=96, seed=4):
    inp = _inputs(e, k, d, f, t, seed)
    jw, jids = jmd.route_topk(jnp.asarray(inp["logits"]), k)
    tw, tids = tmd.route_topk(torch.from_numpy(inp["logits"]), k)
    return inp, (jnp.asarray(inp["x"]), jw, jids), \
        (torch.from_numpy(inp["x"]), tw, tids)


@pytest.mark.parametrize("capacity", [4, 12, 96 * 2])  # drops .. none
def test_onehot_dispatch_matches_jax(capacity):
    inp, (jx, jw, jids), (tx, tw, tids) = _single_shard_case()
    jp, tp = _experts(inp, "jax"), _experts(inp, "torch")
    want = jmd.onehot_dispatch_combine(
        jx, jw, jids, num_experts=16, capacity=capacity,
        expert_fn=lambda xin: jmoe._expert_fn(jp, xin))
    got = tmd.onehot_dispatch_combine(
        tx, tw, tids, num_experts=16, capacity=capacity,
        expert_fn=lambda xin: tmoe.expert_fn(tp, xin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
def test_sort_dispatch_single_shard_matches_jax(cf):
    inp, (jx, jw, jids), (tx, tw, tids) = _single_shard_case()
    jp, tp = _experts(inp, "jax"), _experts(inp, "torch")
    want = jmd.sort_dispatch_shard(
        jx, jw, jids, jp, cfg=jmd.MoeDispatchConfig(16, 2, cf), ep_size=1,
        expert_fn=jmoe._expert_fn)
    got = tmd.sort_dispatch(tx, tw, tids, tp,
                            cfg=tmd.MoeDispatchConfig(16, 2, cf),
                            expert_fn=tmoe.expert_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["dense", "onehot"])
def test_moe_ffn_matches_jax(impl):
    from repro.configs import get as jget
    from repro_torch.configs import get as tget

    jcfg = jget("qwen2-moe-a2.7b").reduced(dtype="float32",
                                           dispatch_impl=impl)
    tcfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32",
                                           dispatch_impl=impl)
    p = jmoe.init_moe_ffn(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(5).normal(size=(2, 12, jcfg.d_model)).astype(
        np.float32)
    assert jcfg.n_experts < jcfg.n_experts_padded  # 8 experts, 16 columns
    with masked_reference_router(jcfg):
        want = jmoe.moe_ffn(p, jcfg, jnp.asarray(x))
    ffn = tmoe.MoeFFN(tcfg, None, dtype=torch.float32)
    state = {k: torch.from_numpy(np.array(v)) for k, v in p.items()
             if k != "shared"}
    state.update({f"shared.{k}": torch.from_numpy(np.array(v))
                  for k, v in p["shared"].items()})
    ffn.load_state_dict(state, strict=True, assign=True)
    got = ffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the pad experts (fault 4): never routed to, on every dispatch path
# ---------------------------------------------------------------------------

# name: (dispatch_impl, ep_size, dp, (B, S))
PATHS = {"dense": ("dense", 1, 1, (2, 24)),
         "onehot": ("onehot", 1, 1, (2, 24)),
         "sort_mesh": ("sort", 4, 2, (2, 24)),
         "sort_decode": ("sort", 4, 2, (8, 1))}


def _moe_case(n_experts, impl="dense", seed=6, shape=(2, 24)):
    """A reduced qwen2-moe FFN (float32 masters with gradients) with
    `n_experts` real experts of 16 columns, and its input."""
    from repro_torch.configs import get as tget

    cfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32",
                                          dispatch_impl=impl,
                                          n_experts=n_experts)
    ffn = tmoe.MoeFFN(cfg, torch.Generator().manual_seed(seed),
                      dtype=torch.float32, requires_grad=True)
    x = np.random.default_rng(seed).normal(size=shape + (cfg.d_model,))
    return cfg, ffn, torch.from_numpy(x.astype(np.float32))


def _spy(monkeypatch):
    """Record the logits and ids of every route_topk call of the port."""
    calls = []

    def route_topk(logits, top_k):
        w, ids = ROUTE_TOPK(logits, top_k)
        calls.append((logits.detach(), w.detach(), ids))
        return w, ids

    monkeypatch.setattr(tmd, "route_topk", route_topk)
    return calls


ROUTE_TOPK = tmd.route_topk


@pytest.mark.parametrize("path", sorted(PATHS))
def test_router_never_selects_a_pad_expert(monkeypatch, path):
    impl, ep, dp, shape = PATHS[path]
    cfg, ffn, x = _moe_case(8, impl, shape=shape)
    assert cfg.n_experts_padded == 16
    with torch.no_grad():  # pads would win every token without the mask
        ffn.router[:, cfg.n_experts:] = 10.0 * ffn.router.abs().max()
    calls = _spy(monkeypatch)
    out = ffn(x, ep_size=ep, dp=dp)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    (logits, w, ids), = calls
    assert int(ids.max()) < cfg.n_experts
    probs = torch.softmax(logits, dim=-1)
    assert bool((probs[:, cfg.n_experts:] == 0).all())
    np.testing.assert_allclose(probs[:, :cfg.n_experts].sum(-1).numpy(), 1.0,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)


@pytest.mark.parametrize("path", ["dense", "onehot", "sort_mesh"])
def test_pad_experts_get_no_gradient(path):
    impl, ep, dp, shape = PATHS[path]
    cfg, ffn, x = _moe_case(8, impl, shape=shape)
    x.requires_grad_(True)
    ffn(x, ep_size=ep, dp=dp).square().sum().backward()
    n = cfg.n_experts
    assert bool((ffn.router.grad[:, n:] == 0).all())
    assert float(ffn.router.grad[:, :n].abs().max()) > 0
    for w in (ffn.w_gate, ffn.w_up, ffn.w_down):
        assert bool((w.grad[n:] == 0).all())
        assert float(w.grad[:n].abs().max()) > 0
    assert float(x.grad.abs().max()) > 0


@pytest.mark.parametrize("impl", ["dense", "onehot"])
def test_config_without_pads_is_unchanged_by_the_mask(impl):
    """16 experts of 16 columns: the router runs exactly the unmasked
    computation, bit for bit, and matches the unpatched reference."""
    from repro.configs import get as jget

    cfg, ffn, x = _moe_case(16, impl)
    assert cfg.n_experts == cfg.n_experts_padded
    logits = x.reshape(-1, cfg.d_model) @ ffn.router
    assert tmoe.mask_pad_experts(logits, cfg.n_experts) is logits
    with torch.no_grad():
        got = ffn(x)
        w, ids = tmd.route_topk(logits, cfg.top_k)
        tokens = x.reshape(-1, cfg.d_model)
        if impl == "onehot":
            cap = tmd._round_up(tokens.shape[0] * cfg.top_k / cfg.n_experts
                                * cfg.moe_capacity_factor, 8)
            routed = tmd.onehot_dispatch_combine(
                tokens, w, ids, num_experts=16, capacity=cap,
                expert_fn=lambda xin: tmoe.expert_fn(ffn.experts(), xin))
        else:
            routed = tmd.sort_dispatch(
                tokens, w, ids, ffn.experts(),
                cfg=tmd.MoeDispatchConfig(16, cfg.top_k,
                                          cfg.moe_capacity_factor),
                expert_fn=tmoe.expert_fn)
        want = routed.reshape(x.shape) + tlayers.swiglu(ffn.shared, x)
    assert torch.equal(got, want)
    jcfg = jget("qwen2-moe-a2.7b").reduced(dtype="float32",
                                           dispatch_impl=impl, n_experts=16)
    p = {k: jnp.asarray(v.detach().numpy())
         for k, v in ffn.state_dict().items() if "." not in k}
    p["shared"] = {k: jnp.asarray(v.detach().numpy())
                   for k, v in ffn.shared.items()}
    ref = jmoe.moe_ffn(p, jcfg, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the mesh paths: shards as a batch axis against shard_map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SORTS))
def test_sort_dispatch_matches_jax_mesh(jax_ref, name):
    (dp, ep), e, k, d, f, t, cf = SORTS[name]
    inp = _inputs(e, k, d, f, t)
    w, ids = tmd.route_topk(torch.from_numpy(inp["logits"]), k)
    got = tmd.sort_dispatch(torch.from_numpy(inp["x"]), w, ids,
                            _experts(inp, "torch"),
                            cfg=tmd.MoeDispatchConfig(e, k, cf),
                            expert_fn=tmoe.expert_fn, ep_size=ep, dp=dp)
    assert got.shape == (t, d)
    assert float(np.abs(got.numpy() - jax_ref[name]).max()) < 1e-4


def test_sort_dispatch_without_drops_equals_dense_sum(jax_ref):
    # With capacity to spare, the dispatch is the dense mixture
    # sum_k w_k * expert_{id_k}(x), as the reference test holds it.
    (dp, ep), e, k, d, f, t, cf = SORTS["dp2_ep4"]
    inp = _inputs(e, k, d, f, t)
    x = torch.from_numpy(inp["x"])
    w, ids = tmd.route_topk(torch.from_numpy(inp["logits"]), k)
    prm = _experts(inp, "torch")
    every = tmoe.expert_fn(prm, x[None].expand(e, -1, -1).contiguous())
    dense = (every.permute(1, 0, 2).gather(1, ids[..., None].expand(-1, -1, d))
             * w[..., None]).sum(dim=1)
    assert float(np.abs(dense.numpy() - jax_ref["dp2_ep4"]).max()) < 1e-4


def test_ep_replicated_matches_jax_mesh(jax_ref):
    e, k, t, d, f = DECODE
    inp = _inputs(e, k, d, f, t, seed=1)
    w, ids = tmd.route_topk(torch.from_numpy(inp["logits"]), k)
    got = tmd.ep_replicated(torch.from_numpy(inp["x"]), w, ids,
                            _experts(inp, "torch"),
                            cfg=tmd.MoeDispatchConfig(e, k), ep_size=4,
                            expert_fn=tmoe.expert_fn)
    np.testing.assert_allclose(got.numpy(), jax_ref["decode"], rtol=2e-5,
                               atol=2e-5)


def test_sort_dispatch_rejects_uneven_shards():
    x = torch.zeros((10, 4))
    w = torch.ones((10, 2)) / 2
    ids = torch.zeros((10, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="divide evenly"):
        tmd.sort_dispatch(x, w, ids, {}, cfg=tmd.MoeDispatchConfig(8, 2),
                          expert_fn=tmoe.expert_fn, ep_size=4)


# ---------------------------------------------------------------------------
# the fixed-shape scatter against the boolean mask it replaced
# ---------------------------------------------------------------------------


def _mask_sort_dispatch(x, weights, ids, expert_params, *, cfg, expert_fn,
                        ep_size=1, dp=1):
    """core/moe_dispatch.sort_dispatch as it was before its scatter got a
    fixed shape: the kept arrivals written through a boolean mask (which
    syncs with the card on its count, and which "meta" tensors cannot
    run)."""
    ep = ep_size
    s = dp * ep
    n_tok, d = x.shape
    k = ids.shape[-1]
    e = cfg.num_experts
    e_local = e // ep
    t = n_tok // s
    tk = t * k
    dev = x.device
    xs = x.reshape(s, t, d)
    flat_w = weights.reshape(s, tk)
    se, sslot = torch.sort(ids.reshape(s, tk).long(), dim=-1, stable=True)
    bounds = torch.arange(1, ep, device=dev) * e_local
    starts = torch.searchsorted(se, bounds.expand(s, ep - 1).contiguous(),
                                side="left")
    zero = torch.zeros((s, 1), dtype=torch.int64, device=dev)
    starts = torch.cat([zero, starts], dim=-1)
    ends = torch.cat([starts[:, 1:], zero + tk], dim=-1)
    counts = ends - starts
    cap = tmd._round_up(tk / ep * cfg.capacity_factor, 8)
    c = torch.arange(cap, device=dev)
    src = (starts[..., None] + c).clamp(0, tk - 1).reshape(s, ep * cap)
    valid = (c < counts[..., None]).reshape(s, ep * cap)
    send_e = torch.where(valid, se.gather(1, src), e)
    slot_clip = torch.where(valid, sslot.gather(1, src), tk - 1)
    send_tok = slot_clip // k
    send_x = torch.where(
        valid[..., None],
        xs.gather(1, send_tok[..., None].expand(-1, -1, d)), 0)
    send_w = torch.where(valid, flat_w.gather(1, slot_clip), 0.0)
    recv_e = tmd._all_to_all(send_e.reshape(s, ep, cap), dp, ep)
    recv_x = tmd._all_to_all(send_x.reshape(s, ep, cap, d), dp, ep)
    m = ep * cap
    ge, gperm = torch.sort(recv_e.reshape(s, m), dim=-1, stable=True)
    rx = recv_x.reshape(s, m, d)
    first = (torch.arange(s, device=dev) % ep) * e_local
    local_bounds = first[:, None] + torch.arange(e_local, device=dev)
    estarts = torch.searchsorted(ge, local_bounds, side="left")
    local_eid = (ge - first[:, None]).clamp(0, e_local - 1)
    rank = torch.arange(m, device=dev) - estarts.gather(1, local_eid)
    ecap = max(tmd._round_up(tk / e_local * cfg.capacity_factor, 8), 8)
    keep = (rank < ecap) & (ge < e)
    exp_in = torch.zeros((s, e_local, ecap, d), dtype=x.dtype, device=dev)
    shard = torch.arange(s, device=dev)[:, None].expand(s, m)
    arrived = rx.gather(1, gperm[..., None].expand(-1, -1, d))
    exp_in[shard[keep], local_eid[keep], rank[keep]] = arrived[keep]
    grid = exp_in.reshape(dp, ep, e_local, ecap, d).permute(1, 2, 0, 3, 4)
    exp_out = expert_fn(expert_params, grid.reshape(e, dp * ecap, d))
    d_out = exp_out.shape[-1]
    exp_out = (exp_out.reshape(ep, e_local, dp, ecap, d_out)
               .permute(2, 0, 1, 3, 4).reshape(s, e_local * ecap, d_out))
    sel = local_eid * ecap + torch.where(keep, rank, 0)
    y_sorted = torch.where(
        keep[..., None],
        exp_out.gather(1, sel[..., None].expand(-1, -1, d_out)), 0)
    y_arrival = torch.empty_like(y_sorted).scatter_(
        1, gperm[..., None].expand(-1, -1, d_out), y_sorted)
    y_back = tmd._all_to_all(y_arrival.reshape(s, ep, cap, d_out), dp, ep)
    y_flat = y_back.reshape(s, m, d_out)
    w_flat = send_w[..., None].to(y_flat.dtype)
    tok = (torch.arange(s, device=dev)[:, None] * t + send_tok).reshape(-1)
    out = torch.zeros((n_tok, d_out), dtype=y_flat.dtype, device=dev)
    return out.index_add_(0, tok, (y_flat * w_flat).reshape(-1, d_out))


def _dispatch_with_grads(fn, inp, mesh, e, k, cf):
    """fn's output on `inp` and the gradients of its weighted sum with
    respect to the tokens, the router logits and the expert banks."""
    dp, ep = mesh
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    logits = torch.from_numpy(inp["logits"]).requires_grad_(True)
    prm = {n: torch.from_numpy(inp[n]).requires_grad_(True)
           for n in ("w_gate", "w_up", "w_down")}
    w, ids = tmd.route_topk(logits, k)
    out = fn(x, w, ids, prm, cfg=tmd.MoeDispatchConfig(e, k, cf),
             expert_fn=tmoe.expert_fn, ep_size=ep, dp=dp)
    probe = torch.from_numpy(np.random.default_rng(9).normal(
        size=tuple(out.shape)).astype(np.float32))
    (out * probe).sum().backward()
    return [out.detach(), x.grad, logits.grad] + [prm[n].grad for n in prm]


# (dp, ep), capacity factor: the first of each mesh drops pairs
SCATTER_CASES = [((1, 1), 0.5), ((1, 1), 8.0), ((2, 4), 1.0), ((2, 4), 4.0),
                 ((1, 8), 0.75), ((1, 8), 8.0)]


@pytest.mark.parametrize("mesh,cf", SCATTER_CASES)
def test_fixed_shape_scatter_equals_the_boolean_mask(mesh, cf):
    """Outputs and gradients bit-identical to the boolean-mask version,
    where pairs are dropped over capacity and where none are."""
    e, k, d, f, t = 16, 2, 32, 64, 256
    inp = _inputs(e, k, d, f, t, seed=11)
    got = _dispatch_with_grads(tmd.sort_dispatch, inp, mesh, e, k, cf)
    want = _dispatch_with_grads(_mask_sort_dispatch, inp, mesh, e, k, cf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    roomy = _dispatch_with_grads(tmd.sort_dispatch, inp, mesh, e, k, 64.0)
    drops = not torch.equal(got[0], roomy[0])
    assert drops == (cf < 2), (mesh, cf)


@pytest.mark.parametrize("mesh", [(1, 1), (2, 4)])
def test_sort_dispatch_runs_on_meta_tensors(mesh):
    """The scatter has a fixed shape, so the dispatch runs on "meta"
    tensors (the dry run's) and nothing in it waits on a count."""
    dp, ep = mesh
    e, k, d, f, t = 16, 2, 32, 64, 256
    x = torch.empty((t, d), device="meta")
    w, ids = tmd.route_topk(torch.empty((t, e), device="meta"), k)
    prm = {"w_gate": torch.empty((e, d, f), device="meta"),
           "w_up": torch.empty((e, d, f), device="meta"),
           "w_down": torch.empty((e, f, d), device="meta")}
    out = tmd.sort_dispatch(x, w, ids, prm,
                            cfg=tmd.MoeDispatchConfig(e, k, 1.0),
                            expert_fn=tmoe.expert_fn, ep_size=ep, dp=dp)
    assert out.device.type == "meta" and out.shape == (t, d)
