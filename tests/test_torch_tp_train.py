"""Tensor parallelism on the rank mesh: training with sequence
parallelism, the MoE block under TP and EP, the vocab-parallel loss,
the sharded greedy pick and a TP checkpoint, over gloo ranks on the CPU
(one spawn of 4; rank bodies in tests/tp_ranks.py).

What must hold:

  (a) one train step of the reduced mistral-nemo-12b and qwen2-moe-a2.7b
      over data 2 x model 2, the residual stream split over the
      sequence between the blocks (Megatron-SP), from the reference's
      weights: the loss and every gradient (each rank's slice of a
      split tensor) equal one process's within 1e-5, the step's global
      gradient norm within relative 1e-5, the parameters after it
      within chip_smoke's train.identity bounds, and every replicated
      parameter is bit-identical on every rank;
  (b) the MoE block with TP shared experts and EP banks (data 1 x model
      4, data 2 x model 2) routes bit-identically to the batch-axis form
      (tests/test_torch_moe_ranks.py's oracle: capacities, sent and
      received expert ids, keep, ranks), and its output and input
      gradient agree within 1e-5;
  (c) the vocab-parallel ce_loss (model 2 and 4) gives the plain loss's
      value and gradient within 1e-6;
  (d) sharded_argmax on logits with planted ties is torch.argmax;
  (e) the checkpoint the TP ranks write (split tensors gathered along
      dims 0 and 1) loads in one process, where a one-process save of it
      has the same crc32 for every leaf, and in the reference;
  (f) a TP rank's train step runs on "meta" tensors (the dry run's) and
      peaks lower than one process's; serve_decode over data 2 x model
      2 gives one process's tokens.
"""
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tp_ranks
from repro.configs import get as jget
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro_torch.configs import get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.models.api import ce_loss
from repro_torch.models.moe import MoeFFN
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          make_train_step, train_state_of)

torch.set_num_threads(2)

PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5  # chip_smoke's train.identity bounds
MOE_LAYOUTS = [{"data": 1, "model": 4}, {"data": 2, "model": 2}]
LOSS_LAYOUTS = [{"data": 2, "model": 2}, {"data": 1, "model": 4}]
TRAIN = {"dense": ("mistral-nemo-12b", {}),
         "moe": ("qwen2-moe-a2.7b", {"n_experts": 16,
                                     "dispatch_impl": "sort"})}
TRAIN_BATCH = (4, 16)


def _layout(axes):
    return axes["data"], axes["model"]


def _train_cfg(name, lib="torch"):
    arch, over = TRAIN[name]
    return (tget if lib == "torch" else jget)(arch).reduced(
        dtype="float32", remat=False, **over)


def _train_case(name):
    jcfg = _train_cfg(name, "jax")
    tree = jax.tree.map(np.asarray,
                        japi.build(jcfg).init(jax.random.PRNGKey(17)))
    rng = np.random.default_rng(sum(map(ord, name)))
    b, s = TRAIN_BATCH
    vocab = jcfg.vocab
    batch = {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")}
    return _train_cfg(name), tree, batch


def _moe_case():
    cfg = _train_cfg("moe")
    block = MoeFFN(cfg, torch.Generator().manual_seed(23),
                   dtype=torch.float32)
    rng = np.random.default_rng(23)
    shape = TRAIN_BATCH + (cfg.d_model,)
    return (cfg, {n: p.detach().numpy() for n, p in
                  block.state_dict().items()},
            rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _loss_inputs():
    rng = np.random.default_rng(29)
    b, s, v = 3, 5, 256
    tied = rng.integers(0, 4, (b, s, v)).astype(np.float32)  # many ties
    tied[0, 0] = 0.0  # all equal: index 0
    tied[0, 1] = 0.0
    tied[0, 1, [70, 130, 250]] = 5.0  # the max on three ranks' slices
    tied[0, 2] = -1.0
    tied[0, 2, 255] = 2.0  # only on the last slice
    return {"logits": rng.normal(size=(b, s, v)).astype(np.float32) * 3,
            "labels": rng.integers(0, v, (b, s)).astype(np.int64),
            "tied": tied}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    train_args = {}
    for name in TRAIN:
        ck = str(tmp_path_factory.mktemp(f"tp_ckpt_{name}"))
        train_args[name] = (*_train_case(name), ck)
    got = tmesh.spawn_ranks(tp_ranks.four, 4, MOE_LAYOUTS, _moe_case(),
                            LOSS_LAYOUTS, _loss_inputs(), train_args)
    return got, {n: a[-1] for n, a in train_args.items()}


@pytest.fixture(scope="module")
def one_process():
    """Each train case in one process: loss and gradients of the batch,
    one train step's metrics and parameters after it."""
    out = {}
    for name in TRAIN:
        cfg, tree, batch = _train_case(name)
        model = tapi.build(cfg)
        params = model.params_from_reference(tree, device="cpu",
                                             trainable=True)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss = model.loss(params, tb)
        loss.backward()
        grads = {n: p.grad.clone() if p.grad is not None
                 else torch.zeros_like(p)
                 for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-4, warmup_steps=1,
                                         total_steps=4))
        state, m = make_train_step(model, tcfg)(
            train_state_of(params, tcfg), tb)
        out[name] = {"loss": float(loss.detach()), "grads": {
            n: g.numpy() for n, g in grads.items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "after": {n: p.detach().numpy().copy() for n, p in
                      state["params"].named_parameters()},
            "cfg": cfg, "tcfg": tcfg}
    return out


def _mine(arr, name, split, j, m):
    """Rank j's slice of a one-process tensor (of m along its dim)."""
    if name not in split:
        return arr
    k = arr.shape[split[name]] // m
    return np.take(arr, np.arange(j * k, (j + 1) * k), axis=split[name])


# ---------------------------------------------------------------------------
# (a) one train step with sequence parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_step_with_sp_matches_one_process(name, four, one_process):
    want = one_process[name]
    ranks = [r["train"][name] for r in four[0]]
    for r, rank in enumerate(ranks):
        j = r % 2
        split = rank["split"]
        assert rank["sp"] and rank["replicas_identical"]
        assert split and all(n.endswith((".scale", ".router"))
                             for n in want["grads"] if n not in split)
        assert abs(rank["loss"] - want["loss"]) <= 1e-5
        for n, g in rank["grads"].items():
            np.testing.assert_allclose(
                g, _mine(want["grads"][n], n, split, j, 2), rtol=0,
                atol=1e-5, err_msg=n)
        m = rank["metrics"]
        assert abs(m["loss"] - want["metrics"]["loss"]) <= 1e-5
        assert abs(m["grad_norm"] - want["metrics"]["grad_norm"]) <= \
            1e-5 * want["metrics"]["grad_norm"]
        assert m == ranks[0]["metrics"]
        for n, a in rank["after"].items():
            np.testing.assert_allclose(
                a, _mine(want["after"][n], n, split, j, 2),
                rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=n)
            if n in split:  # a slice: the same on both data rows
                assert np.array_equal(a, ranks[j]["after"][n]), n


# ---------------------------------------------------------------------------
# (b) the MoE block under TP and EP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", MOE_LAYOUTS,
                         ids=[f"dp{a['data']}_tp{a['model']}"
                              for a in MOE_LAYOUTS])
def test_moe_block_routing_under_tp_and_ep_is_bit_identical(axes, four):
    dp, ep = _layout(axes)
    cfg, state, x, probe = _moe_case()
    block = MoeFFN(cfg, None, dtype=torch.float32, requires_grad=True)
    block.load_state_dict({n: torch.from_numpy(a) for n, a in state.items()},
                          strict=True, assign=True)
    block.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    routing = {}
    out = block(xt, ep_size=ep, dp=dp, routing=routing)
    (out * torch.from_numpy(probe)).sum().backward()
    ranks = [r["moe"][(dp, ep)] for r in four[0]]
    assert {n for n in ranks[0]["placement"]} >= {
        "w_gate", "w_up", "w_down", "shared.w_gate", "shared.w_up",
        "shared.w_down"}
    for i, rank in enumerate(ranks):  # rank g*ep + j: shard g*ep + j
        rec = rank["routing"]
        assert (rec["cap"], rec["ecap"]) == (routing["cap"],
                                             routing["ecap"])
        for key in ("send_e", "recv_e", "keep", "rank"):
            np.testing.assert_array_equal(rec[key][0],
                                          routing[key][i].numpy(),
                                          err_msg=key)
    b = x.shape[0] // dp
    for g in range(dp):
        for j in range(ep):
            rank = ranks[g * ep + j]
            np.testing.assert_allclose(
                rank["out"], out.detach().numpy()[g * b:(g + 1) * b],
                rtol=0, atol=1e-5)
            np.testing.assert_allclose(
                rank["x"], xt.grad.numpy()[g * b:(g + 1) * b], rtol=0,
                atol=1e-5)


# ---------------------------------------------------------------------------
# (c), (d) the vocab-parallel loss and the sharded pick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("axes", LOSS_LAYOUTS,
                         ids=[f"dp{a['data']}_tp{a['model']}"
                              for a in LOSS_LAYOUTS])
def test_vocab_parallel_ce_loss_matches_the_plain_loss(axes, four):
    inp = _loss_inputs()
    lg = torch.from_numpy(inp["logits"]).requires_grad_()
    loss = ce_loss(lg, torch.from_numpy(inp["labels"]))
    loss.backward()
    m = axes["model"]
    v = lg.shape[-1] // m
    for r, rank in enumerate(four[0]):
        got = rank["loss"][_layout(axes)]
        j = r % m
        assert abs(got["loss"] - float(loss.detach())) <= 1e-6
        np.testing.assert_allclose(got["grad"],
                                   lg.grad.numpy()[..., j * v:(j + 1) * v],
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("axes", LOSS_LAYOUTS,
                         ids=[f"dp{a['data']}_tp{a['model']}"
                              for a in LOSS_LAYOUTS])
def test_sharded_pick_breaks_ties_as_argmax(axes, four):
    tied = torch.from_numpy(_loss_inputs()["tied"])
    want = torch.argmax(tied, dim=-1).numpy()
    assert want[0, 0] == 0 and want[0, 1] == 70 and want[0, 2] == 255
    for rank in four[0]:
        np.testing.assert_array_equal(rank["loss"][_layout(axes)]["pick"],
                                      want)


# ---------------------------------------------------------------------------
# (e) the TP checkpoint
# ---------------------------------------------------------------------------


def _manifest(d, step):
    with open(f"{d}/step_{step:08d}/manifest.json") as f:
        return json.load(f)["leaves"]


def test_tp_checkpoint_loads_in_one_process_and_the_reference(
        four, one_process, tmp_path):
    ranks, dirs = four
    cfg, tcfg = one_process["dense"]["cfg"], one_process["dense"]["tcfg"]
    after = [r["train"]["dense"]["after"] for r in ranks]
    split = ranks[0]["train"]["dense"]["split"]
    assert set(split.values()) == {0, 1}  # both dims are gathered
    state, step = ckpt.load(abstract_train_state(tapi.build(cfg), tcfg),
                            dirs["dense"], device="cpu")
    assert step == 1 and int(state["opt"]["step"]) == 1
    for n, p in state["params"].named_parameters():
        whole = np.concatenate([after[j][n] for j in range(2)],
                               axis=split[n]) if n in split else after[0][n]
        np.testing.assert_array_equal(p.detach().numpy(), whole, err_msg=n)
    ckpt.save(state, str(tmp_path), 1)  # one process writes it again
    tp_leaves, one_leaves = _manifest(dirs["dense"], 1), _manifest(
        str(tmp_path), 1)
    assert tp_leaves == one_leaves
    for leaf in tp_leaves.values():
        assert isinstance(leaf["crc32"], int)
    jcfg = _train_cfg("dense", "jax")
    jparams = japi.build(jcfg).init(jax.random.PRNGKey(17))
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jstate = {"params": jparams, "opt": {"mu": zeros, "nu": zeros,
                                         "step": jnp.int32(0)}}
    back, jstep = jckpt.load(jax.eval_shape(lambda: jstate), dirs["dense"])
    assert jstep == 1
    from repro_torch.models import naming

    named = naming.reference_state(cfg, jax.tree.map(np.asarray,
                                                     back["params"]))
    mine = dict(state["params"].named_parameters())
    for n, a in named.items():
        np.testing.assert_array_equal(a, mine[n].detach().numpy(),
                                      err_msg=n)
        assert zlib.crc32(np.ascontiguousarray(a).tobytes()) == zlib.crc32(
            mine[n].detach().numpy().tobytes())


# ---------------------------------------------------------------------------
# (f) the dry run and the example
# ---------------------------------------------------------------------------


def test_tp_step_runs_on_meta_tensors():
    from repro_torch.launch import dryrun

    cfg = _train_cfg("dense")
    peaks = {}
    for m in (1, 2):
        mesh = tmesh.layout_mesh({"data": 1, "model": m}, 0)
        model = tapi.build(cfg, mesh=mesh)
        tcfg = TrainConfig()
        state = abstract_train_state(model, tcfg)
        wq = state["params"].blocks[0].attn.wq
        assert wq.shape == (cfg.d_model, cfg.n_heads * cfg.head_dim // m)
        batch = {k: torch.empty(TRAIN_BATCH, dtype=torch.int32,
                                device="meta") for k in ("tokens", "labels")}
        peaks[m] = dryrun.peak_bytes(make_train_step(model, tcfg,
                                                     mesh=mesh), state,
                                     batch)
    assert 0 < peaks[2] < peaks[1]


def test_serve_decode_example_over_a_mesh():
    from repro_torch.examples import serve_decode

    argv = ["--batch", "4", "--prompt-len", "8", "--new-tokens", "6",
            "--device", "cpu"]
    one = serve_decode.main(argv)
    ranked = serve_decode.main(argv + ["--mesh", "data=2,model=2"])
    assert ranked["ranks"] == 4 and ranked["mesh"] == {"data": 2,
                                                       "model": 2}
    assert torch.equal(ranked["tokens"], one["tokens"])
