"""Tensor parallelism on the rank mesh, serving: the transformer family's
`attn_sharding="heads"` configs over gloo ranks on the CPU
(launch/mesh.spawn_ranks; rank bodies in tests/tp_ranks.py, which
imports no jax).

Each rank builds the model on a (data x model) mesh from the
reference's weights (params_from_reference(..., mesh=)): it holds 1/tp
of every projection, FFN (or shared-expert) width and the tied
vocabulary, and (MoE) E/tp experts. On its data row of the batch it
runs the prefill, decode steps fed fixed tokens and greedy generate.
What must hold, on data 1 x model 2, data 2 x model 2 and data 2 x
model 4 (the reduced mistral-nemo-12b and qwen2-moe-a2.7b over model 2,
tinyllama-1.1b with 8 heads and 4 KV heads and qwen2-moe-a2.7b over
model 4):

  (a) the prefill's and the decode steps' logits, gathered over the
      vocab and the data rows, equal the port's one-process model's
      within 1e-5;
  (b) and the reference's on an emulated (data, model) mesh of host
      devices with its parameters placed by to_shardings(param_pspecs),
      within 1e-4 (tests/test_torch_moe_ranks.py's reference bound);
  (c) the greedy tokens are the one-process model's, and every rank of
      a data row holds the same tokens and the same replicated
      parameters (sha256); sampled tokens (temperature 1, a seeded
      generator) are the same on every rank of a data row;
  (d) a rank holds its slice: its parameter bytes are the one
      process's / tp plus the replicated norms (and router), and its KV
      cache KV/tp heads.
"""
import json

import jax
import numpy as np
import pytest
import torch

import tp_ranks
from helpers import run_with_devices
from repro.configs import get as jget
from repro.models import api as japi
from repro_torch.configs import get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api as tapi
from repro_torch.serve.engine import ServeConfig, generate

torch.set_num_threads(2)

BATCH, PROMPT, FEED, NEW = 4, 16, 3, 6
# name: (arch, reduced() overrides)
CASES = {"dense2": ("mistral-nemo-12b", {}),
         "dense4": ("tinyllama-1.1b", {"n_heads": 8, "n_kv_heads": 4}),
         "moe": ("qwen2-moe-a2.7b", {"n_experts": 16,
                                     "dispatch_impl": "sort"})}
LAYOUTS = {(1, 2): ("dense2", "moe"), (2, 2): ("dense2", "moe"),
           (2, 4): ("dense4", "moe")}
PARAMS = [(layout, name) for layout, names in LAYOUTS.items()
          for name in names]
IDS = [f"dp{d}_tp{m}-{name}" for (d, m), name in PARAMS]
TOL = {"one": 1e-5, "reference": 1e-4}


def _over(name):
    return dict(CASES[name][1], dtype="float32", remat=False)


def _cfg(name, lib="torch"):
    arch, _ = CASES[name]
    return (tget if lib == "torch" else jget)(arch).reduced(**_over(name))


def _inputs(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    vocab = _cfg(name).vocab
    return (rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int64),
            rng.integers(0, vocab, (BATCH, FEED)).astype(np.int64))


def _tree(name):
    jcfg = _cfg(name, "jax")
    return jax.tree.map(np.asarray,
                        japi.build(jcfg).init(jax.random.PRNGKey(11)))


@pytest.fixture(scope="module")
def cases():
    return {name: (_cfg(name), _tree(name), *_inputs(name))
            for name in CASES}


@pytest.fixture(scope="module")
def one_process(cases):
    """The port's one-process model on the same weights and inputs."""
    out = {}
    for name, (cfg, tree, prompts, feed) in cases.items():
        model = tapi.build(cfg)
        params = model.params_from_reference(tree, device="cpu")
        batch = {"tokens": torch.from_numpy(prompts)}
        logits, cache = model.prefill(params, batch, max_len=PROMPT + FEED)
        dec = []
        for t in range(FEED):
            lg, cache = model.decode_step(
                params, cache, torch.from_numpy(feed[:, t:t + 1]), PROMPT + t)
            dec.append(lg.numpy())
        gen, _ = generate(model, params, batch,
                          ServeConfig(max_new_tokens=NEW))
        out[name] = {"prefill": logits.numpy(), "decode": dec,
                     "tokens": gen.numpy(),
                     "param_bytes": sum(p.numel() * p.element_size()
                                        for p in params.parameters()),
                     "replicated_bytes": {
                         n: p.numel() * p.element_size()
                         for n, p in params.named_parameters()},
                     "cache_shape": tuple(cache["k"].shape)}
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    """{layout: [each rank's {case: serve(...)}]}: one spawn a world."""
    out = {}
    for layout, names in LAYOUTS.items():
        d, m = layout
        axes = [{"data": d, "model": m}]
        got = tmesh.spawn_ranks(
            tp_ranks.serve_cases, d * m, axes,
            {layout: {n: (*cases[n], NEW) for n in names}})
        out[layout] = [r[layout] for r in got]
    return out


_JAX = """
import json
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.launch import sharding as shd
from repro.models import api

inp = dict(np.load({inp!r}))
out = {{}}
for key, (layout, arch, over) in json.loads({cases!r}).items():
    d, m = layout
    cfg = get(arch).reduced(**over)
    mesh = Mesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                ("data", "model"))
    pre = key + ":tree:"
    flat = {{k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}}
    tree = {{}}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {{}})
        node[last] = v
    model = api.build(cfg, mesh=mesh, dp_axes=("data",))
    params = jax.device_put(tree, shd.to_shardings(
        mesh, shd.param_pspecs(cfg, tree, mesh)))
    rows = NamedSharding(mesh, P("data", None))
    prompts = jax.device_put(inp[key + ":prompts"].astype(np.int32), rows)
    feed = inp[key + ":feed"].astype(np.int32)
    s, n = prompts.shape[1], feed.shape[1]
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, {{"tokens": t}}, max_len=s + n))(params, prompts)
    out[key + ":prefill"] = np.asarray(logits)
    step = jax.jit(model.decode_step)
    for t in range(n):
        lg, cache = step(params, cache,
                         jax.device_put(feed[:, t:t + 1], rows), s + t)
        out[key + ":decode" + str(t)] = np.asarray(lg)
np.savez({outp!r}, **out)
print("OK")
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def reference(cases, tmp_path_factory):
    """The reference's prefill and decode logits on an emulated (data,
    model) mesh of 8 host devices, one jit a case, in one subprocess."""
    d = tmp_path_factory.mktemp("jax_tp")
    arrays, spec = {}, {}
    for layout, name in PARAMS:
        key = f"{layout[0]}x{layout[1]}-{name}"
        _, tree, prompts, feed = cases[name]
        arrays.update({f"{key}:tree:{k}": v
                       for k, v in _flat(tree).items()})
        arrays[f"{key}:prompts"], arrays[f"{key}:feed"] = prompts, feed
        spec[key] = (list(layout), CASES[name][0], _over(name))
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **arrays)
    run_with_devices(_JAX.format(inp=inp, outp=outp,
                                 cases=json.dumps(spec)))
    with np.load(outp) as f:
        return dict(f)


def _gathered(ranks, layout, name, key):
    """The data rows' results in batch order (rank g * tp holds row g)."""
    d, m = layout
    per = [r[name] for r in ranks[layout]]
    if key == "decode":
        return [np.concatenate([per[g * m]["decode"][t] for g in range(d)])
                for t in range(FEED)]
    return np.concatenate([per[g * m][key] for g in range(d)])


@pytest.mark.parametrize("layout,name", PARAMS, ids=IDS)
def test_logits_match_the_one_process_model(layout, name, ranks,
                                            one_process):
    want = one_process[name]
    d, m = layout
    per = [r[name] for r in ranks[layout]]
    for g in range(d):  # every rank of a data row gathers the same logits
        for j in range(m):
            assert np.array_equal(per[g * m + j]["prefill"],
                                  per[g * m]["prefill"])
    np.testing.assert_allclose(_gathered(ranks, layout, name, "prefill"),
                               want["prefill"], rtol=0, atol=TOL["one"])
    for t, got in enumerate(_gathered(ranks, layout, name, "decode")):
        np.testing.assert_allclose(got, want["decode"][t], rtol=0,
                                   atol=TOL["one"], err_msg=f"step {t}")


@pytest.mark.parametrize("layout,name", PARAMS, ids=IDS)
def test_logits_match_the_reference_on_a_mesh(layout, name, ranks,
                                              reference):
    key = f"{layout[0]}x{layout[1]}-{name}"
    np.testing.assert_allclose(_gathered(ranks, layout, name, "prefill"),
                               reference[f"{key}:prefill"], rtol=0,
                               atol=TOL["reference"])
    for t, got in enumerate(_gathered(ranks, layout, name, "decode")):
        np.testing.assert_allclose(got, reference[f"{key}:decode{t}"],
                                   rtol=0, atol=TOL["reference"],
                                   err_msg=f"step {t}")


@pytest.mark.parametrize("layout,name", PARAMS, ids=IDS)
def test_greedy_tokens_match_the_one_process_model(layout, name, ranks,
                                                   one_process):
    d, m = layout
    per = [r[name] for r in ranks[layout]]
    assert all(r["replicas_identical"] for r in per)
    for g in range(d):
        for j in range(m):
            assert np.array_equal(per[g * m + j]["tokens"],
                                  per[g * m]["tokens"])
    np.testing.assert_array_equal(_gathered(ranks, layout, name, "tokens"),
                                  one_process[name]["tokens"])


@pytest.mark.parametrize("layout,name", PARAMS, ids=IDS)
def test_sampled_tokens_are_the_same_on_every_rank_of_a_row(layout, name,
                                                            ranks, cases):
    """Temperature 1: the whole logits gathered over "model", every rank
    draws from the same seeded generator."""
    d, m = layout
    per = [r[name] for r in ranks[layout]]
    vocab = cases[name][0].padded_vocab
    for g in range(d):
        for j in range(m):
            assert np.array_equal(per[g * m + j]["sampled"],
                                  per[g * m]["sampled"])
        assert ((per[g * m]["sampled"] >= 0)
                & (per[g * m]["sampled"] < vocab)).all()


@pytest.mark.parametrize("layout,name", PARAMS, ids=IDS)
def test_a_rank_holds_its_slice(layout, name, ranks, one_process, cases):
    d, m = layout
    want = one_process[name]
    rank = ranks[layout][0][name]
    split = rank["split"]
    replicated = sum(b for n, b in want["replicated_bytes"].items()
                     if n not in split)
    assert all(n.endswith((".scale", ".router")) for n in
               want["replicated_bytes"] if n not in split)
    assert rank["param_bytes"] == (want["param_bytes"] - replicated) // m \
        + replicated
    lead, b, s, kv, dh = want["cache_shape"]
    assert kv == cases[name][0].n_kv_heads
    assert rank["cache_shape"] == (lead, b // d, s, kv // m, dh)
