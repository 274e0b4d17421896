"""The tensor-parallel placements against the reference's rules, without
ranks: launch/sharding.split_dims (what a rank model holds its slice of,
launch/sharding.rank_split) against the "model" entries of the
reference's param_pspecs (src/repro/launch/sharding.py) for every
`attn_sharding="heads"` config on both production meshes, a rank's
local shapes (parameters, KV cache, logits) against the specs through
local_shape, the refusal of KV heads that do not divide tp, and the
constrain_* twins' conditions.

The one deviation from the rules is named here: the norm scales, which
the rules' size fallback puts over "model" for d_model >= 4096, stay
whole on a rank (a d-vector each; gathering it would cost a collective
a norm). FSDP's data-axis entries are not executed either; split_dims
reads only the "model" entries.
"""
import functools

import jax
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
from repro_torch.models import layers, naming

MESHES = {"dp16_tp16": {"data": 16, "model": 16},
          "pod2_dp16_tp16": {"pod": 2, "data": 16, "model": 16}}
HEADS = [jconfigs.get(a).name for a in jconfigs.ARCH_IDS
         if jconfigs.get(a).attn_sharding == "heads"]


class StandInMesh:
    """What the reference's rules read of a mesh: its axes and sizes."""

    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


@functools.lru_cache(maxsize=None)
def _reference_model_dims(arch, mesh):
    """{port state name: dim} of the reference's "model" entries, the
    layer axis of a stacked leaf not counted."""
    jcfg = jconfigs.get(arch)
    params = japi.build(jcfg).abstract_params()
    specs = jshd.param_pspecs(jcfg, params, StandInMesh(MESHES[mesh]))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    stacked = naming.stacked_layers(tget(arch))
    out = {}
    for path, spec in flat:
        name = jshd._path_str(path)
        head, _, rest = name.partition("/")
        entries = tuple(spec)
        layers_ = stacked.get(head)
        if layers_:
            entries = entries[1:]
        dims = [i for i, e in enumerate(entries)
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        if not dims:
            continue
        if layers_:
            for i in range(layers_):
                out[f"{head}.{i}.{rest.replace('/', '.')}"] = dims[0]
        else:
            out[name.replace("/", ".")] = dims[0]
    return out


def test_heads_configs_are_the_five():
    assert sorted(HEADS) == sorted([
        "tinyllama-1.1b", "granite-3-8b", "mistral-nemo-12b",
        "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", HEADS)
def test_rank_split_is_the_model_entries_of_param_pspecs(arch, mesh):
    want = _reference_model_dims(arch, mesh)
    got = tshd.split_dims(tget(arch), MESHES[mesh])
    scales = {n for n in want if n.endswith(".scale")}
    assert {n: d for n, d in want.items() if n not in scales} == got
    # the only entries left out: the norm scales, over "model" by size
    d_model = tget(arch).d_model
    assert bool(scales) == (d_model >= 4096)


@pytest.mark.parametrize("arch", HEADS)
def test_a_rank_model_holds_its_slices(arch):
    """On data 2 x model 4 (every heads config's KV heads divide 4), the
    rank model's parameters are the one-process shapes cut along
    rank_split's dims, and its bytes are the one process's / 4 plus the
    replicated norms and router."""
    cfg = tget(arch)
    axes = {"data": 2, "model": 4}
    one = dict(tapi.build(cfg).abstract_params().named_parameters())
    model = tapi.build(cfg, mesh=tmesh.layout_mesh(axes, 6))
    local = dict(model.abstract_params().named_parameters())
    split = tshd.rank_split(model.abstract_params())
    assert split == tshd.split_dims(cfg, axes)
    assert sorted(local) == sorted(one)
    for n, p in local.items():
        want = list(one[n].shape)
        if n in split:
            want[split[n]] //= 4
        assert list(p.shape) == want, n
    replicated = sum(p.numel() for n, p in one.items() if n not in split)
    assert all(n.endswith((".scale", ".router")) for n in one
               if n not in split)
    total = sum(p.numel() for p in one.values())
    assert sum(p.numel() for p in local.values()) == \
        (total - replicated) // 4 + replicated


@pytest.mark.parametrize("arch", HEADS)
def test_local_cache_and_logits_shapes_match_the_specs(arch):
    cfg = tget(arch)
    axes = {"data": 2, "model": 4}
    b, s = 8, 32
    one = tapi.build(cfg).abstract_cache(b, s)
    specs = tshd.cache_pspecs(cfg, one, axes, batch=b)
    rank = tapi.build(cfg, mesh=tmesh.layout_mesh(axes, 3))
    mine = rank.abstract_cache(b // 2, s)  # the rank's data row
    for name, t in one.items():
        assert specs[name][3] == "model"  # KV heads over "model"
        assert tuple(mine[name].shape) == tshd.local_shape(
            t.shape, specs[name], axes), name
    logits = tshd.local_shape((b, s, cfg.padded_vocab),
                              tshd.logits_pspec(cfg, axes), axes)
    assert logits == (b // 2, s, cfg.padded_vocab // 4)


def test_a_rank_prefill_gives_its_logits_slice_on_meta():
    cfg = tget("mistral-nemo-12b").reduced(dtype="float32")
    axes = {"data": 2, "model": 2}
    model = tapi.build(cfg, mesh=tmesh.layout_mesh(axes, 1))
    params = model.init(None)
    tokens = torch.empty((2, 8), dtype=torch.int64, device="meta")
    logits, cache = model.prefill(params, {"tokens": tokens})
    assert tuple(logits.shape) == tshd.local_shape(
        (4, 1, cfg.padded_vocab), tshd.logits_pspec(cfg, axes), axes)
    assert cache["k"].shape[3] == cfg.n_kv_heads // 2


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mistral-nemo-12b",
                                  "qwen2-moe-a2.7b"])
def test_kv_heads_below_tp_raise(arch):
    cfg = tget(arch).reduced(n_heads=4, n_kv_heads=2)
    mesh = tmesh.layout_mesh({"data": 1, "model": 4}, 0)
    with pytest.raises(NotImplementedError, match="item 2"):
        tapi.build(cfg, mesh=mesh)
    with pytest.raises(NotImplementedError, match="KV heads"):
        tapi.new_model(cfg, None, mesh=mesh)
    # the production mesh: tinyllama's 4 and mistral-nemo's 8 KV heads
    full = tget(arch)
    if full.n_kv_heads % 16:
        with pytest.raises(NotImplementedError, match="item 2"):
            tapi.build(full, mesh=tmesh.layout_mesh(MESHES["dp16_tp16"], 0))


@pytest.mark.parametrize("arch", ["llava-next-34b", "minicpm3-4b",
                                  "hymba-1.5b", "xlstm-125m",
                                  "whisper-base"])
def test_other_configs_stay_replicated_on_a_rank(arch):
    cfg = tget(arch)
    mesh = tmesh.layout_mesh({"data": 2, "model": 4}, 5)
    assert tshd.split_dims(cfg, mesh) == {}
    model = tapi.build(cfg, mesh=mesh).abstract_params()
    assert tshd.rank_split(model) == {}
    one = tapi.build(cfg).abstract_params()
    assert [p.shape for p in model.parameters()] == \
        [p.shape for p in one.parameters()]


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 64), (("data",), "model", None)),
    ((3, 8, 64), (None, "model", None)),
    ((4, 6, 64), (("data",), None, None)),
])
def test_constrain_acts_conditions(shape, want):
    mesh = tmesh.layout_mesh({"data": 2, "model": 4}, 0)
    assert layers.constrain_acts(shape, mesh) == want
    assert layers.constrain_seq(shape + (16,), mesh) == want + (None,)
    assert layers.constrain_acts(shape, None) is None


def test_constrain_heads_and_tree():
    mesh = tmesh.layout_mesh({"data": 2, "model": 4}, 6)  # data 1, model 2
    assert layers.constrain_heads((4, 8, 8, 16), mesh) == (
        ("data",), None, "model", None)
    assert layers.constrain_heads((4, 8, 2, 16), mesh) == (
        ("data",), None, None, None)
    t = torch.arange(8 * 6).reshape(8, 6)
    cut = layers.constrain_tree({"a": t, "b": t}, {"a": ("model", None)},
                                mesh)  # rows [2 * 2, 3 * 2) of 8
    assert torch.equal(cut["a"], t[4:6]) and torch.equal(cut["b"], t)
    with pytest.raises(ValueError, match="does not split"):
        layers.constrain_tree({"a": t}, {"a": (None, "model")}, mesh)
