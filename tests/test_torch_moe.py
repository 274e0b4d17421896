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
"""
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
    want = jmoe.moe_ffn(p, jcfg, jnp.asarray(x))
    ffn = tmoe.MoeFFN(tcfg, None)
    state = {k: torch.from_numpy(np.array(v)) for k, v in p.items()
             if k != "shared"}
    state.update({f"shared.{k}": torch.from_numpy(np.array(v))
                  for k, v in p["shared"].items()})
    ffn.load_state_dict(state, strict=True, assign=True)
    got = ffn(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
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
