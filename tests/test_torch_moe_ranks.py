"""Expert parallelism across ranks (core/collectives.py's grouped
collectives, core/moe_dispatch's rank forms, models/moe.MoeFFN on a
rank, training and checkpoints over a (data x model) mesh), on the CPU:
gloo ranks spawned by launch/mesh.spawn_ranks, rank bodies in
tests/moe_ranks.py (which imports no jax).

What must hold:

  (a) the grouped collectives along "model" and "data" of a data 2 x
      model 2 mesh equal their numpy definitions, and so do their
      gradients: the split/gather pair passes the gradient exactly (not
      multiplied by the axis size), psum's backward passes it through,
      psum_grad's sums it;
  (b) the sort dispatch over ranks and the decode dispatch (data 1 x
      model 4 and data 2 x model 2 on 4 ranks, data 2 x model 4 on 8)
      route bit-identically to the batch-axis form (ids, and the sort's
      capacities, sent and received expert ids, keep and ranks) and to
      the reference on an emulated (2, 4) mesh (ids), and their outputs
      and the gradients of tokens, router logits and experts agree with
      both oracles within the stated bounds; the same for the MoE block
      (router, shared experts and dispatch) on each layout;
  (c) two train steps of a reduced qwen2-moe over data 2 x model 2
      ranks, from the reference's weights (params_from_reference with
      mesh=), give the batch-axis step's losses and parameters; every
      replicated parameter is bit-identical on every rank;
  (d) the checkpoint the ranks write loads back on the ranks, in one
      process (equal to the ranks' state gathered) and in the reference;
  (e) a rank killed mid-dispatch makes the other raise within the
      group's timeout;
  (f) the examples' rank paths (train_moe over data 2 x model 4,
      serve_decode over 4 ranks) agree with their one-process runs.

Bounds: against the batch-axis form, 1e-5 (outputs, gradients; the two
forms run the same operations, grouped differently); against the
reference, tests/test_torch_moe.py's: 1e-4 for the sort dispatch and
the block, 2e-5 for the decode dispatch.
"""
import json
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import moe_ranks
from helpers import run_with_devices
from repro.configs import get as jget
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro_torch.configs import get as tget
from repro_torch.core import moe_dispatch as tmd
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models import naming
from repro_torch.models.moe import MoeFFN, expert_fn
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          make_train_step, train_state_of)

torch.set_num_threads(2)

KEYS = moe_ranks.EXPERT_KEYS
LAYOUTS4 = [{"data": 1, "model": 4}, {"data": 2, "model": 2}]
LAYOUTS8 = [{"data": 2, "model": 4}]
# name: ((kind, E, K, capacity factor), (T, d, d_ff)); "tight" drops
DISPATCH = {"sort_roomy": (("sort", 16, 4, 4.0), (256, 32, 64)),
            "sort_tight": (("sort", 16, 2, 1.0), (256, 32, 64)),
            "decode": (("decode", 16, 2, 1.25), (16, 32, 64))}
# name: (capacity factor, (B, S)) of the reduced qwen2-moe block
FFN = {"prefill_roomy": (8.0, (4, 16)), "prefill_tight": (1.0, (4, 16)),
       "decode": (8.0, (8, 1))}
TOL = {"batch": 1e-5, "sort": 1e-4, "decode": 2e-5}


def _dispatch_inputs(name):
    (kind, e, k, cf), (t, d, f) = DISPATCH[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return dict(
        x=rng.normal(size=(t, d)).astype(np.float32),
        logits=rng.normal(size=(t, e)).astype(np.float32),
        w_gate=(rng.normal(size=(e, d, f)) * 0.1).astype(np.float32),
        w_up=(rng.normal(size=(e, d, f)) * 0.1).astype(np.float32),
        w_down=(rng.normal(size=(e, f, d)) * 0.1).astype(np.float32),
        probe=rng.normal(size=(t, d)).astype(np.float32))


def _ffn_config(name, lib="torch"):
    get = tget if lib == "torch" else jget
    return get("qwen2-moe-a2.7b").reduced(
        dtype="float32", dispatch_impl="sort", n_experts=16,
        moe_capacity_factor=FFN[name][0])


def _ffn_inputs(name):
    """The block's weights (one process's names) and its input and probe."""
    cfg = _ffn_config(name)
    block = MoeFFN(cfg, torch.Generator().manual_seed(7), dtype=torch.float32)
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = FFN[name][1] + (cfg.d_model,)
    state = {n: p.detach().numpy() for n, p in block.state_dict().items()}
    return (cfg, state, rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the oracles: the batch-axis form, the reference on a (2, 4) mesh
# ---------------------------------------------------------------------------


def _batch_dispatch(name, dp, ep):
    (kind, e, k, cf), _ = DISPATCH[name]
    inp = _dispatch_inputs(name)
    x = torch.from_numpy(inp["x"]).requires_grad_()
    logits = torch.from_numpy(inp["logits"]).requires_grad_()
    prm = {n: torch.from_numpy(inp[n]).requires_grad_() for n in KEYS}
    w, ids = tmd.route_topk(logits, k)
    routing = {}
    if kind == "sort":
        out = tmd.sort_dispatch(x, w, ids, prm,
                                cfg=tmd.MoeDispatchConfig(e, k, cf),
                                expert_fn=expert_fn, ep_size=ep, dp=dp,
                                routing=routing)
    else:
        out = tmd.ep_replicated(x, w, ids, prm,
                                cfg=tmd.MoeDispatchConfig(e, k, cf),
                                ep_size=ep, expert_fn=expert_fn)
    (out * torch.from_numpy(inp["probe"])).sum().backward()
    return {"out": out.detach().numpy(), "x": x.grad.numpy(),
            "logits": logits.grad.numpy(), "ids": ids.numpy(),
            "experts": {n: p.grad.numpy() for n, p in prm.items()},
            "routing": routing}


def _batch_ffn(name, dp, ep):
    cfg, state, x, probe = _ffn_inputs(name)
    block = MoeFFN(cfg, None, dtype=torch.float32, requires_grad=True)
    block.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()},
                          strict=True, assign=True)
    block.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, ep_size=ep, dp=dp)
    (out * torch.from_numpy(probe)).sum().backward()
    return {"out": out.detach().numpy(), "x": xt.grad.numpy(),
            "grads": {n: p.grad.numpy() for n, p in block.named_parameters()}}


_JAX = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get
from repro.core import compat
from repro.core import moe_dispatch as md
from repro.models import moe
from repro.models.moe import _expert_fn

mesh = compat.make_mesh((2, 4), ("data", "model"))
inp = dict(np.load({inp!r}))
out = {{}}
for name, ((kind, e, k, cf), _) in json.loads({dispatch!r}).items():
    a = {{key[len(name) + 1:]: v for key, v in inp.items()
         if key.startswith(name + ":")}}
    keys = ("w_gate", "w_up", "w_down")
    cfg = md.MoeDispatchConfig(num_experts=e, top_k=k, capacity_factor=cf)
    pspec = {{n: P("model", None, None) for n in keys}}
    if kind == "sort":
        fn = md.make_sort_dispatch(mesh, cfg, _expert_fn,
                                   token_spec=P(("data", "model"), None),
                                   param_spec=pspec)
    else:
        fn = compat.shard_map(
            lambda tk, ww, ii, ep: md.ep_replicated_shard(
                tk, ww, ii, ep, cfg=cfg, ep_size=4, expert_fn=_expert_fn),
            mesh=mesh,
            in_specs=(P("data", None), P("data", None), P("data", None),
                      pspec),
            out_specs=P("data", None), check_vma=False)

    def loss(x, logits, prm):
        w, ids = md.route_topk(logits, k)
        return jnp.sum(fn(x, w, ids, prm) * a["probe"])

    prm = {{n: jnp.asarray(a[n]) for n in keys}}
    x, logits = jnp.asarray(a["x"]), jnp.asarray(a["logits"])
    w, ids = md.route_topk(logits, k)
    out[name + ":out"] = np.asarray(jax.jit(fn)(x, w, ids, prm))
    out[name + ":ids"] = np.asarray(ids)
    gx, gl, gp = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, logits, prm)
    out[name + ":x"], out[name + ":logits"] = np.asarray(gx), np.asarray(gl)
    for n in keys:
        out[name + ":experts:" + n] = np.asarray(gp[n])

for name, cf in json.loads({ffn!r}).items():
    cfg = get("qwen2-moe-a2.7b").reduced(
        dtype="float32", dispatch_impl="sort", n_experts=16,
        moe_capacity_factor=cf)
    pre = "ffn:" + name + ":"
    p = {{key[len(pre):]: jnp.asarray(v) for key, v in inp.items()
         if key.startswith(pre) and "." not in key[len(pre):]
         and key[len(pre):] not in ("x", "probe")}}
    p["shared"] = {{key[len(pre) + 7:]: jnp.asarray(v)
                   for key, v in inp.items()
                   if key.startswith(pre + "shared.")}}
    x, probe = jnp.asarray(inp[pre + "x"]), inp[pre + "probe"]

    def loss(p, x):
        return jnp.sum(moe.moe_ffn(p, cfg, x, mesh=mesh) * probe)

    out[pre + "out"] = np.asarray(jax.jit(
        lambda p, x: moe.moe_ffn(p, cfg, x, mesh=mesh))(p, x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
    out[pre + "x"] = np.asarray(gx)
    for key, v in gp.items():
        if key == "shared":
            for k2, v2 in v.items():
                out[pre + "grad:shared." + k2] = np.asarray(v2)
        else:
            out[pre + "grad:" + key] = np.asarray(v)
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_moe_ranks")
    arrays = {f"{name}:{k}": v for name in DISPATCH
              for k, v in _dispatch_inputs(name).items()}
    for name in FFN:
        _, state, x, probe = _ffn_inputs(name)
        arrays.update({f"ffn:{name}:{k}": v for k, v in state.items()})
        arrays[f"ffn:{name}:x"], arrays[f"ffn:{name}:probe"] = x, probe
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **arrays)
    run_with_devices(_JAX.format(
        inp=inp, outp=outp, dispatch=json.dumps(DISPATCH),
        ffn=json.dumps({n: cf for n, (cf, _) in FFN.items()})))
    with np.load(outp) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the spawns: one of 4 ranks, one of 8
# ---------------------------------------------------------------------------

COLL_M = 2  # data 2 x model 2


def _coll_inputs():
    rng = np.random.default_rng(21)
    return {"blocks": rng.normal(size=(4, 1, 2, 3)).astype(np.float32),
            "probe_blocks": rng.normal(size=(4, 1, 2, 3)).astype(np.float32),
            "rows": rng.normal(size=(4, 5)).astype(np.float32),
            "probe_rows": rng.normal(size=(4, 5)).astype(np.float32),
            "row_x": rng.normal(size=(2, 8, 3)).astype(np.float32),
            "row_probe": rng.normal(size=(2, 8, 3)).astype(np.float32)}


def _moe_args():
    return ({name: (case, _dispatch_inputs(name))
             for name, (case, _) in DISPATCH.items()},
            {name: _ffn_inputs(name) for name in FFN})


TRAIN_BATCH = (8, 16)  # global sequences x tokens


def _train_case():
    """The reduced qwen2-moe (8 experts in 16 columns, sort dispatch), the
    reference's weights as numpy and two global batches."""
    jcfg = jget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False,
                                           dispatch_impl="sort")
    tcfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False,
                                           dispatch_impl="sort")
    tree = jax.tree.map(np.asarray,
                        japi.build(jcfg).init(jax.random.PRNGKey(3)))
    b, s = TRAIN_BATCH
    pipe = TokenPipeline(DataConfig(vocab=tcfg.vocab, seq_len=s,
                                    global_batch=b, num_samples=b * 8),
                         device="cpu")
    batches = [{k: v.numpy() for k, v in pipe.batch_at(i).items()}
               for i in range(2)]
    return tcfg, tree, batches


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("rank_ckpt"))
    cfg, tree, batches = _train_case()
    got = tmesh.spawn_ranks(moe_ranks.four, 4, _coll_inputs(), LAYOUTS4,
                            *_moe_args(), (cfg, tree, batches, ck))
    return got, ck


@pytest.fixture(scope="module")
def eight():
    return tmesh.spawn_ranks(moe_ranks.moe_cases, 8, LAYOUTS8, *_moe_args())


def _moe(four, eight, layout):
    ranks = eight if layout == (2, 4) else four[0]
    return [r["moe"][layout] if "moe" in r else r[layout] for r in ranks]


# ---------------------------------------------------------------------------
# (a) the collectives
# ---------------------------------------------------------------------------


def test_grouped_collectives_and_their_gradients(four):
    inp = _coll_inputs()
    ranks = [r["collectives"] for r in four[0]]
    m = COLL_M
    for r, got in enumerate(ranks):
        g, j = divmod(r, m)
        assert got["coords"] == (g, j)
        assert got["sizes"] == (2, 2, 2) and got["group_sizes"] == (2, 2)
        # along "model": y[src] = what (g, src) sent to j; the gradient
        # of a block is the probe where it arrived
        y, dx = got["a2a.model"]
        for src in range(m):
            np.testing.assert_array_equal(y[0, src],
                                          inp["blocks"][g * m + src][0, j])
            np.testing.assert_array_equal(
                dx[0, src], inp["probe_blocks"][g * m + src][0, j])
        y, dx = got["a2a.data"]
        for src in range(2):
            np.testing.assert_array_equal(y[0, src],
                                          inp["blocks"][src * m + j][0, g])
            np.testing.assert_array_equal(
                dx[0, src], inp["probe_blocks"][src * m + j][0, g])
        y, dx = got["psum"]
        np.testing.assert_allclose(y, inp["rows"][g * m:(g + 1) * m].sum(0),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(dx, inp["probe_rows"][r])
        # split, scale by (owner + 1), gather: y = X * c, dX = P * c
        c = np.repeat(np.arange(1, m + 1, dtype=np.float32), 8 // m)
        y, dx = got["split_gather"]
        np.testing.assert_allclose(y, inp["row_x"][g] * c[:, None], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(dx, inp["row_probe"][g] * c[:, None],
                                   rtol=0, atol=1e-6)
        y, dx = got["psum_grad"]
        np.testing.assert_array_equal(y, inp["row_x"][g] * (j + 1))
        np.testing.assert_allclose(dx, inp["row_probe"][g] * 3.0, rtol=0,
                                   atol=1e-6)
        assert [w for w, _, _ in got["log"]] == [
            "a2a.model", "a2a.model.grad", "a2a.data", "a2a.data.grad",
            "psum", "gather", "gather.grad", "psum.grad"]
        assert all(clock == "host" for _, _, clock in got["log"])


# ---------------------------------------------------------------------------
# (b) the dispatch and the block over ranks
# ---------------------------------------------------------------------------

LAYOUT_IDS = ["dp1_ep4", "dp2_ep2", "dp2_ep4"]
LAYOUTS = [(1, 4), (2, 2), (2, 4)]


def _gathered_dispatch(ranks, name, dp, ep):
    """The ranks' results of a dispatch case in the one-process layout;
    the decode's replicas along "model" must be bit-identical."""
    per = [r["dispatch"][name] for r in ranks]
    kind = DISPATCH[name][0][0]
    if kind == "sort":
        order = per  # rank g*ep + j holds rows (g*ep + j)*t
    else:
        order = [per[g * ep] for g in range(dp)]
        for g in range(dp):
            for j in range(ep):
                for key in ("out", "x", "logits"):
                    assert np.array_equal(per[g * ep + j][key],
                                          per[g * ep][key]), (name, key)
    got = {key: np.concatenate([p[key] for p in order])
           for key in ("out", "x", "logits", "ids")}
    got["experts"] = {n: np.concatenate([sum(per[g * ep + j]["experts"][n]
                                             for g in range(dp))
                                         for j in range(ep)])
                      for n in KEYS}
    got["routing"] = per
    return got


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_over_ranks_matches_batch_axis_and_reference(
        name, layout, four, eight, jax_ref):
    dp, ep = layout
    kind = DISPATCH[name][0][0]
    got = _gathered_dispatch(_moe(four, eight, layout), name, dp, ep)
    want = _batch_dispatch(name, dp, ep)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_array_equal(got["ids"], jax_ref[f"{name}:ids"])
    if kind == "sort":  # routing bit-identical, shard by shard
        for i, rank in enumerate(got["routing"]):
            rec = rank["routing"]
            assert (rec["cap"], rec["ecap"]) == (want["routing"]["cap"],
                                                 want["routing"]["ecap"])
            for key in ("send_e", "recv_e", "keep", "rank"):
                np.testing.assert_array_equal(
                    rec[key][0], want["routing"][key][i].numpy(), err_msg=key)
    for key in ("out", "x", "logits"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=TOL["batch"], err_msg=key)
    for n in KEYS:
        np.testing.assert_allclose(got["experts"][n], want["experts"][n],
                                   rtol=0, atol=TOL["batch"], err_msg=n)
    if kind == "sort" and name == "sort_tight" and layout != (2, 4):
        return  # drops depend on the layout: only (2, 4) is the reference's
    tol = TOL[kind]
    for key in ("out", "x", "logits"):
        np.testing.assert_allclose(got[key], jax_ref[f"{name}:{key}"],
                                   rtol=0, atol=tol, err_msg=key)
    for n in KEYS:
        np.testing.assert_allclose(got["experts"][n],
                                   jax_ref[f"{name}:experts:{n}"], rtol=0,
                                   atol=tol, err_msg=n)


def test_tight_capacity_drops_pairs():
    """The tight case drops routed pairs (so its routing is exercised
    where capacity binds) and the roomy ones drop none."""
    for name, dropped in (("sort_tight", True), ("sort_roomy", False)):
        rec = _batch_dispatch(name, 2, 4)["routing"]
        (_, e, k, _), (t, _, _) = DISPATCH[name]
        kept = int(rec["keep"].sum())
        assert (kept < t * k) == dropped, (name, kept)


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
@pytest.mark.parametrize("name", list(FFN))
def test_moe_block_over_ranks_matches_batch_axis_and_reference(
        name, layout, four, eight, jax_ref):
    """The block's output and the gradients of its input, router, shared
    experts and routed experts: the router and everything before the
    dispatch run replicated on every rank of a data row, and their
    gradients equal the one-process ones (not ep times them)."""
    dp, ep = layout
    ranks = [r["ffn"][name] for r in _moe(four, eight, layout)]
    want = _batch_ffn(name, dp, ep)
    for g in range(dp):  # replicas along "model" bit-identical
        for j in range(ep):
            a, b = ranks[g * ep + j], ranks[g * ep]
            assert np.array_equal(a["out"], b["out"])
            assert np.array_equal(a["x"], b["x"])
            for n, v in a["grads"].items():
                if n not in KEYS:
                    assert np.array_equal(v, b["grads"][n]), n
    got = {"out": np.concatenate([ranks[g * ep]["out"] for g in range(dp)]),
           "x": np.concatenate([ranks[g * ep]["x"] for g in range(dp)])}
    grads = {n: sum(ranks[g * ep]["grads"][n] for g in range(dp))
             for n in want["grads"] if n not in KEYS}
    grads.update({n: np.concatenate([sum(ranks[g * ep + j]["grads"][n]
                                         for g in range(dp))
                                     for j in range(ep)]) for n in KEYS})
    for key in ("out", "x"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=TOL["batch"], err_msg=key)
    for n, v in grads.items():
        np.testing.assert_allclose(v, want["grads"][n], rtol=0,
                                   atol=TOL["batch"], err_msg=n)
    if name == "prefill_tight" and layout != (2, 4):
        return  # drops depend on the layout
    tol = TOL["decode" if name == "decode" else "sort"]
    for key in ("out", "x"):
        np.testing.assert_allclose(got[key], jax_ref[f"ffn:{name}:{key}"],
                                   rtol=0, atol=tol, err_msg=key)
    for n, v in grads.items():
        np.testing.assert_allclose(v, jax_ref[f"ffn:{name}:grad:{n}"],
                                   rtol=0, atol=tol, err_msg=n)


# ---------------------------------------------------------------------------
# (c), (d) training over ranks and the rank checkpoint
# ---------------------------------------------------------------------------

PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5  # chip_smoke's train.identity bounds


@pytest.fixture(scope="module")
def one_process_train():
    cfg, tree, batches = _train_case()
    model = tapi.build(cfg, ep_size=2, dp=2)
    params = model.params_from_reference(tree, device="cpu", trainable=True)
    loaded = {n: p.detach().numpy().copy()
              for n, p in params.named_parameters()}
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=1, total_steps=4))
    state = train_state_of(params, tcfg)
    step = make_train_step(model, tcfg)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return cfg, tcfg, loaded, metrics, state


def _is_bank(name):
    """A routed expert bank (split over "model" on a rank)."""
    *_, parent, key = name.split(".")
    return parent == "ffn" and key in KEYS


def _slice(name, arr, j, ep):
    """Rank j's part of a one-process parameter."""
    if _is_bank(name):
        n = arr.shape[0] // ep
        return arr[j * n:(j + 1) * n]
    return arr


def test_params_from_reference_keeps_the_rank_slice(four,
                                                    one_process_train):
    _, _, loaded, _, _ = one_process_train
    ranks = [r["train"] for r in four[0]]
    for r, rank in enumerate(ranks):
        j = r % 2
        assert sorted(rank["loaded"]) == sorted(loaded)
        for n, a in rank["loaded"].items():
            np.testing.assert_array_equal(a, _slice(n, loaded[n], j, 2),
                                          err_msg=n)
        assert rank["loaded"]["blocks.0.ffn.w_gate"].shape[0] == 8  # 16 / 2


def test_train_steps_over_ranks_match_the_batch_axis_step(
        four, one_process_train):
    _, _, _, metrics, state = one_process_train
    ranks = [r["train"] for r in four[0]]
    for rank in ranks:  # the mean loss and the global norm on every rank
        for got, want in zip(rank["metrics"], metrics):
            assert abs(got["loss"] - want["loss"]) < 1e-5
            assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-5 * (
                1 + want["grad_norm"])
            assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
        assert rank["metrics"] == ranks[0]["metrics"]
    one = {n: p.detach().numpy() for n, p in
           state["params"].named_parameters()}
    for r, rank in enumerate(ranks):
        for n, a in rank["after"].items():
            want = _slice(n, one[n], r % 2, 2)
            np.testing.assert_allclose(a, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=n)
            if not _is_bank(n):  # replicated: every rank
                assert np.array_equal(a, ranks[0]["after"][n]), n
            else:  # an expert bank: the same on both data rows
                assert np.array_equal(a, ranks[r % 2]["after"][n]), n
    assert all(rank["reloaded_equal"] for rank in ranks)


def test_rank_checkpoint_loads_in_one_process_and_the_reference(
        four, one_process_train):
    ranks, ck = four
    cfg, tcfg, _, _, _ = one_process_train
    target = abstract_train_state(tapi.build(cfg), tcfg)
    state, step = ckpt.load(target, ck, device="cpu")
    assert step == 2 and int(state["opt"]["step"]) == 2
    after = [r["train"]["after"] for r in ranks]
    for n, p in state["params"].named_parameters():
        whole = np.concatenate([after[j][n] for j in range(2)]) \
            if _is_bank(n) else after[0][n]
        np.testing.assert_array_equal(p.detach().numpy(), whole, err_msg=n)
    jcfg = jget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False,
                                           dispatch_impl="sort")
    jparams = japi.build(jcfg).init(jax.random.PRNGKey(3))
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jstate = {"params": jparams, "opt": {"mu": zeros, "nu": zeros,
                                         "step": jnp.int32(0)}}
    back, jstep = jckpt.load(jax.eval_shape(lambda: jstate), ck)
    assert jstep == 2
    for key, tree in (("params", back["params"]),
                      ("mu", back["opt"]["mu"])):
        named = naming.reference_state(cfg, jax.tree.map(np.asarray, tree))
        mine = (dict(state["params"].named_parameters()) if key == "params"
                else state["opt"]["mu"])
        for n, a in named.items():
            np.testing.assert_array_equal(a, mine[n].detach().numpy(),
                                          err_msg=n)


def test_train_step_refuses_a_pod_axis():
    cfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32")
    mesh = tmesh.layout_mesh({"pod": 2, "data": 1, "model": 2}, 0)
    with pytest.raises(NotImplementedError, match="item 3"):
        make_train_step(tapi.build(cfg), TrainConfig(), mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 3"):
        tapi.build(cfg, mesh=mesh)


def test_rank_step_runs_on_meta_tensors():
    """A rank's train step on "meta" tensors (the dry run's): the
    collectives return their shapes, and the rank holds E/ep experts."""
    from repro_torch.launch import dryrun

    cfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False,
                                          dispatch_impl="sort")
    peaks = {}
    for ep in (1, 2):
        mesh = tmesh.layout_mesh({"data": 1, "model": ep}, 0)
        model = tapi.build(cfg, mesh=mesh)
        tcfg = TrainConfig()
        state = abstract_train_state(model, tcfg)
        assert state["params"].blocks[0].ffn.w_up.shape[0] == 16 // ep
        batch = {k: torch.empty((4, 16), dtype=torch.int32, device="meta")
                 for k in ("tokens", "labels")}
        peaks[ep] = dryrun.peak_bytes(make_train_step(model, tcfg,
                                                      mesh=mesh), state,
                                      batch)
    assert 0 < peaks[2] < peaks[1]


# ---------------------------------------------------------------------------
# (e) a rank dies mid-dispatch
# ---------------------------------------------------------------------------


def test_rank_killed_mid_dispatch_makes_the_other_raise(tmp_path):
    timeout_s = 5.0
    inp = _dispatch_inputs("sort_roomy")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=moe_ranks.dead_in_dispatch,
                         args=(r, 2, str(tmp_path / "rdzv"), str(tmp_path),
                               timeout_s, inp)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(90)
        assert [p.exitcode for p in procs] == [0, 3]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    seconds, err = (tmp_path / "rank0.txt").read_text().splitlines()
    assert err != "None", "the dispatch with a dead peer returned"
    assert float(seconds) < timeout_s + 20
    assert not (tmp_path / "rank1.txt").exists()


# ---------------------------------------------------------------------------
# (f) the examples' rank paths
# ---------------------------------------------------------------------------


def test_train_moe_example_over_ranks(tmp_path):
    from repro_torch.examples import train_moe

    argv = ["--steps", "3", "--batch", "8", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck")]
    one = train_moe.main(argv)
    ranked = train_moe.main(argv + ["--ranks", "8"])
    assert ranked["ranks"] == 8 and ranked["mesh"] == {"data": 2, "model": 4}
    np.testing.assert_allclose(ranked["losses"], one["losses"], rtol=0,
                               atol=1e-5)
    assert ranked["params"] == one["params"]


def test_serve_decode_example_over_ranks():
    from repro_torch.examples import serve_decode

    argv = ["--arch", "qwen2-moe-a2.7b", "--batch", "4", "--prompt-len", "8",
            "--new-tokens", "6", "--device", "cpu"]
    one = serve_decode.main(argv)
    ranked = serve_decode.main(argv + ["--ranks", "4"])
    assert ranked["ranks"] == 4
    assert torch.equal(ranked["tokens"], one["tokens"])
