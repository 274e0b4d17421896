"""launch/sharding.py against the reference's src/repro/launch/sharding.py.

For every arch config of src/repro/configs/ and both production mesh
shapes ({"data": 16, "model": 16}, and with a "pod" axis of 2), the
port's four rule sets give the reference's PartitionSpecs:
param_pspecs on the reference's parameter tree (the port's model
through models/naming: stacked (L, ...) leaves), batch_pspecs on each
applicable cell's inputs, cache_pspecs on each decode cell's cache, and
logits_pspec. The reference reads only `mesh.shape` and
`mesh.axis_names`, so a stand-in object with those needs no devices.
Specs are compared entry by entry, padded to the tensor's rank, with a
one-axis tuple read as that axis (the same spec either way).

Beside them: the rank path applies the rules' expert-parallel answer
(rank_split names exactly the banks the rules split over "model" on
their expert axis) and their batch answer (local_batch), and a named
mesh's layout (index_of, size_of) is the reference's row-major one.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import api as japi
from repro_torch.configs import get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.models import api as tapi

MESHES = {"dp16_tp16": {"data": 16, "model": 16},
          "pod2_dp16_tp16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = list(jconfigs.ARCH_IDS)


class StandInMesh:
    """What the reference's rules read of a mesh: its axes and sizes."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


def _norm(spec, nd):
    out = []
    for e in tuple(spec) + (None,) * (nd - len(spec)):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(None if e == () else e)
    return tuple(out)


def _flat_specs(specs, shapes):
    """{'/'-joined path: normalised spec} of the reference's spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jshd._path_str(path): _norm(s, len(shapes[jshd._path_str(path)]))
            for path, s in leaves}


def _shapes(tree):
    return {jshd._path_str(path): tuple(leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port(specs):
    return {k: _norm(v, len(v)) for k, v in specs.items()}


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = jconfigs.get(arch), tget(arch)
    return jcfg, japi.build(jcfg), tcfg, tapi.build(tcfg)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    _, jm, _, tm = _models(arch)
    return jm.abstract_params(), tm.abstract_params()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_the_reference(arch, mesh):
    jcfg, _, tcfg, _ = _models(arch)
    jparams, tparams = _abstract(arch)
    axes = MESHES[mesh]
    want = _flat_specs(jshd.param_pspecs(jcfg, jparams, StandInMesh(axes)),
                       _shapes(jparams))
    got = _port(tshd.param_pspecs(tcfg, tparams, axes))
    assert got == want
    assert tshd.reference_shapes(tparams) == _shapes(jparams)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_the_reference(arch, mesh):
    jcfg, jm, tcfg, tm = _models(arch)
    axes = MESHES[mesh]
    stand_in = StandInMesh(axes)
    for cell in tapi.applicable_shapes(tcfg):
        jspecs, tspecs = jm.input_specs(cell), tm.input_specs(cell)
        if "cache" in jspecs:  # decode: the token and the cache
            b = tapi.SHAPES[cell]["batch"]
            want = _flat_specs(jshd.cache_pspecs(jcfg, jspecs["cache"],
                                                 stand_in, batch=b),
                               _shapes(jspecs["cache"]))
            assert _port(tshd.cache_pspecs(tcfg, tspecs["cache"], axes,
                                           batch=b)) == want, cell
            jspecs = {"token": jspecs["token"]}
            tspecs = {"token": tspecs["token"]}
        want = _flat_specs(jshd.batch_pspecs(jcfg, jspecs, stand_in),
                           _shapes(jspecs))
        assert _port(tshd.batch_pspecs(tcfg, tspecs, axes)) == want, cell


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_pspec_matches_the_reference(arch, mesh):
    jcfg, _, tcfg, _ = _models(arch)
    axes = MESHES[mesh]
    want = _norm(jshd.logits_pspec(jcfg, StandInMesh(axes)), 3)
    assert _norm(tshd.logits_pspec(tcfg, axes), 3) == want
    # a RankMesh with the same axes reads the same
    rank = tmesh.layout_mesh(axes, 0)
    assert tshd.logits_pspec(tcfg, rank) == tshd.logits_pspec(tcfg, axes)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])
def test_rank_split_is_the_rules_expert_axis(arch):
    """The banks a rank model splits are the leaves whose rule puts
    "model" on the expert axis of an (L, E, ...) bank, and nothing else;
    a rank holds E/ep experts of each."""
    cfg = tget(arch)
    axes = {"data": 2, "model": 4}
    specs = tshd.param_pspecs(cfg, tapi.build(cfg).abstract_params(), axes)
    banks = {name for name, spec in specs.items()
             if name.split("/")[-1] in ("w_gate", "w_up", "w_down")
             and "ffn/shared" not in name and spec[1] == "model"}
    assert banks and all(name.startswith("blocks/ffn/") for name in banks)
    model = tapi.build(cfg, mesh=tmesh.layout_mesh(axes, 5)).abstract_params()
    split = tshd.rank_split(model)
    assert set(split.values()) == {0}
    assert {f"blocks/{n.split('.', 2)[2].replace('.', '/')}"
            for n in split} == banks
    assert len(split) == 3 * cfg.n_layers
    bank = dict(model.named_parameters())["blocks.0.ffn.w_up"]
    assert bank.shape[0] == cfg.n_experts_padded // 4


def test_local_batch_splits_the_data_axes():
    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3),
             "odd": torch.arange(6).reshape(3, 2)}
    for rank in range(8):
        mesh = tmesh.layout_mesh({"data": 2, "model": 4}, rank)
        g = rank // 4
        got = tshd.local_batch(batch, mesh)
        assert torch.equal(got["tokens"], batch["tokens"][4 * g:4 * g + 4])
        assert got["odd"] is batch["odd"]  # 3 rows do not split: whole
    one = tshd.local_batch(batch, tmesh.layout_mesh({"data": 1, "model": 4},
                                                    3))
    assert one["tokens"] is batch["tokens"]


def test_named_mesh_layout_is_row_major():
    axes = {"pod": 2, "data": 3, "model": 4}
    for rank in range(24):
        mesh = tmesh.layout_mesh(axes, rank)
        p, rest = divmod(rank, 12)
        g, j = divmod(rest, 4)
        assert (mesh.index_of("pod"), mesh.index_of("data"),
                mesh.index_of("model")) == (p, g, j)
        assert mesh.data_axes == ("pod", "data")
        assert mesh.index_of(("pod", "data")) == p * 3 + g
        assert mesh.size_of(("pod", "data")) == 6
    with pytest.raises(KeyError, match="no process group"):
        tmesh.layout_mesh(axes, 0).group_of("model")
    with pytest.raises(ValueError, match="multiply"):
        tmesh.check_axes({"data": 2, "model": 4}, 6)
    with pytest.raises(ValueError, match="one of"):
        tmesh.check_axes({"model": 4, "data": 2}, 8)
    np.testing.assert_equal(tmesh.check_axes({"data": 2, "model": 4}, 8),
                            {"data": 2, "model": 4})


# ---------------------------------------------------------------------------
# the reference's pod-group gradient compression (ROADMAP.md §3 fault 9)
# ---------------------------------------------------------------------------

_POD = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get
from repro.core import compat
from repro.models import api
from repro.train import grad_compress as gc

mesh = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
cfg = get("tinyllama-1.1b").reduced(dtype="float32", remat=False)
model = api.build(cfg)
params = model.init(jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab, (8, 17)).astype(np.int32)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
one = jax.jit(jax.grad(model.loss))(params, batch)
placed = jax.device_put(batch, NamedSharding(mesh, P(("pod", "data"), None)))
with mesh:
    sharded = jax.jit(jax.grad(model.loss))(params, placed)
    pod_mean = jax.jit(lambda g: gc.compressed_pod_mean(g, mesh))(sharded)
worst = max(float(jnp.max(jnp.abs(a - b))) for a, b in
            zip(jax.tree.leaves(sharded), jax.tree.leaves(one)))
q = jax.tree.map(lambda g: gc.dequantize(*gc.quantize_int8(g)), sharded)
quant = max(float(jnp.max(jnp.abs(a - b))) for a, b in
            zip(jax.tree.leaves(pod_mean), jax.tree.leaves(q)))
scale = max(float(jnp.max(jnp.abs(a))) for a in jax.tree.leaves(one))
print("RESULT", worst, quant, scale)
"""


def test_reference_pod_gradients_arrive_already_averaged():
    """Fault 9's evidence: under the reference's jit, the gradients of a
    batch split over ("pod", "data") are already the global batch's
    gradients, at full precision, before compressed_pod_mean runs; its
    int8 exchange then averages identical copies (its result is the
    int8 rounding of what came in). Nothing in either package changes."""
    from helpers import run_with_devices

    out = run_with_devices(_POD)
    worst, quant, scale = map(float, out.split("RESULT")[1].split())
    assert worst <= 1e-6 * max(scale, 1.0)  # already the global gradient
    assert quant <= 1e-6 * max(scale, 1.0)  # the mean of identical copies
