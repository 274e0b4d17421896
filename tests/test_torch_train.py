"""The port's training substrate against the JAX package: the optimizer,
gradient compression, checkpoints (in both directions), the launch
drivers and the MoE training example.

The first ten tests are the twins of tests/test_train.py (the elastic
reshard in its one-card form: onto a requested device). The JAX
functions run unedited, in-process, or, for the reference's mesh runs
(the pod mean over a (2, 2, 2) mesh and the MoE example's 2x4 mesh),
jit-compiled in one module-scoped run_with_devices subprocess on 8 host
devices. Inputs are drawn with numpy from a seed. Bounds: the reference
tests' own (optimizer 1e-6 relative, int8 error 2/127, losses 1e-4).
The MoE example's reference routes with its pad experts masked (the port
never routes to one: ROADMAP.md §3 fault 4; test_torch_moe.py).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.configs import get as jget
from repro.models import api as japi
from repro.train import checkpoint as jckpt
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch.configs import get as tget
from repro_torch.launch import reshard as treshard
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import naming
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import grad_compress as gc
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, init_opt_state,
                                         lr_at)
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          make_train_step, train_state_of)
from test_torch_moe import MASKED_ROUTER_SRC

torch.set_num_threads(2)

# the MoE example's run here: 3 steps of batch 8 x seq 32 (tokens divide
# the 2 x 4 mesh)
MOE_STEPS, MOE_BATCH, MOE_SEQ = 3, 8, 32

_JAX = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
{masked}
from repro.configs import get
from repro.core.compat import make_mesh
from repro.data.pipeline import DataConfig, TokenPipeline
from repro.launch import sharding as shd
from repro.launch.dryrun import block_specs_of
from repro.models import api as mapi
from repro.train.grad_compress import compressed_pod_mean
from repro.train.optimizer import OptConfig
from repro.train.train_step import TrainConfig, init_train_state, make_train_step

out = {{}}
# the pod mean: tests/test_train.py's case
pod_mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
x = jnp.linspace(-1, 1, 64).reshape(8, 8)
out["pod_mean"] = np.asarray(
    jax.jit(lambda t: compressed_pod_mean({{"g": t}}, pod_mesh))(x)["g"])

# examples/train_moe.py's setup, its first steps
mesh = make_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(
    get("qwen2-moe-a2.7b"),
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_head=32,
    vocab=8192, n_experts=8, top_k=2, d_ff_expert=512, shared_d_ff=512,
    dispatch_impl="sort", moe_capacity_factor=2.0, dtype="float32",
    remat=False, attn_chunk=64, train_microbatches=1,
)
model0 = mapi.build(cfg, mesh=mesh, dp_axes=("data",))
p_specs = shd.param_pspecs(cfg, model0.abstract_params(), mesh)
model = mapi.build(cfg, mesh=mesh, dp_axes=("data",),
                   block_specs=block_specs_of(cfg, p_specs))
tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=20,
                                 total_steps={steps}))
state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
    out["param__" + "__".join(k.key for k in path)] = np.asarray(leaf)
state_specs = {{"params": p_specs,
               "opt": {{"mu": p_specs, "nu": p_specs, "step": P()}}}}
sh = jax.tree.map(lambda s: NamedSharding(mesh, s), state_specs,
                  is_leaf=lambda x: isinstance(x, P))
state = {{k: jax.device_put(state[k], sh[k]) for k in ("params", "opt")}}
step_fn = jax.jit(make_train_step(model, tcfg, mesh=mesh), donate_argnums=0)
data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len={seq},
                                global_batch={batch},
                                num_samples={batch} * 64))
losses = []
for step in range({steps}):
    with mesh:
        state, m = step_fn(state, data.batch_at(step))
    losses.append(float(m["loss"]))
out["moe_losses"] = np.asarray(losses)
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("jax_train") / "out.npz")
    run_with_devices(_JAX.format(
        masked=MASKED_ROUTER_SRC.format(n_experts=8), steps=MOE_STEPS,
        seq=MOE_SEQ, batch=MOE_BATCH, outp=outp))
    with np.load(outp) as f:
        return dict(f)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _nested(flat, prefix):
    """{prefix + "a__b__c": arr} -> {"a": {"b": {"c": arr}}}: the
    reference's pytree from its "__"-joined leaf names."""
    tree = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("__")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = arr
    return tree


# ---------------------------------------------------------------------------
# the twins of tests/test_train.py
# ---------------------------------------------------------------------------


def test_lr_schedule_shape():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    assert float(lr_at(0, cfg)) == 0.0
    assert abs(float(lr_at(10, cfg)) - 1.0) < 1e-6
    assert float(lr_at(100, cfg)) == pytest.approx(0.1, rel=1e-5)
    vals = [float(lr_at(s, cfg)) for s in range(10, 101, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    steps = np.arange(0, 120)
    jcfg = jopt.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    want = np.asarray(jax.vmap(lambda s: jopt.lr_at(s, jcfg))(
        jnp.asarray(steps, jnp.int32)))
    got = lr_at(torch.from_numpy(steps.astype(np.int32)), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params)
    cfg = OptConfig(peak_lr=0.1, warmup_steps=0, total_steps=1000,
                    weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.3
    assert int(state["step"]) == 200 and state["step"].dtype == torch.int32


def test_grad_clip_applies():
    params = {"w": torch.zeros(3)}
    state = init_opt_state(params)
    cfg = OptConfig(clip_norm=1.0, warmup_steps=0)
    _, _, info = adamw_update(params, {"w": torch.full((3,), 100.0)}, state,
                              cfg)
    assert float(info["grad_norm"]) > 1.0  # reported pre-clip
    clipped, gn = clip_by_global_norm({"w": torch.full((3,), 100.0)}, 1.0)
    assert float(gn) == pytest.approx(100 * 3**0.5)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0)


def _reference_test_tree(lib):
    """tests/test_train.py's checkpoint tree, in jnp or torch."""
    if lib == "jax":
        return {"params": {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                           "blocks": [{"w": jnp.ones((2, 2))},
                                      {"w": jnp.zeros((2, 2))}]},
                "step": jnp.int32(7)}
    return {"params": {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "blocks": [{"w": torch.ones((2, 2))},
                                  {"w": torch.zeros((2, 2))}]},
            "step": torch.tensor(7, dtype=torch.int32)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_roundtrip(tmp_path):
    state = _reference_test_tree("torch")
    d = str(tmp_path / "ck")
    ckpt.save(state, d, step=7)
    assert ckpt.latest_step(d) == 7
    loaded, step = ckpt.load(state, d, device="cpu")
    assert step == 7
    for name, a in (("a", state["params"]["a"]), ("step", state["step"])):
        got = loaded["params"][name] if name == "a" else loaded[name]
        assert torch.equal(got, a) and got.dtype == a.dtype
    for i in range(2):
        assert torch.equal(loaded["params"]["blocks"][i]["w"],
                           state["params"]["blocks"][i]["w"])
    # the same leaves, names and checksums as the reference writes
    jd = str(tmp_path / "jck")
    jckpt.save(_reference_test_tree("jax"), jd, step=7)
    assert _manifest(d, 7) == _manifest(jd, 7)


def test_checkpoint_checksum_gate(tmp_path):
    state = {"w": torch.ones((4, 4))}
    d = str(tmp_path / "ck")
    ckpt.save(state, d, step=1)
    f = os.path.join(d, "step_00000001", "w.npy")
    raw = bytearray(open(f, "rb").read())
    raw[-1] ^= 0xFF
    open(f, "wb").write(raw)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.load(state, d, device="cpu")


def test_checkpoint_atomic_overwrite(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save({"w": torch.zeros(2)}, d, step=1)
    ckpt.save({"w": torch.ones(2)}, d, step=2)
    loaded, step = ckpt.load({"w": torch.zeros(2)}, d, device="cpu")
    assert step == 2 and float(loaded["w"][0]) == 1.0
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000001",
                                     "step_00000002"]


def test_elastic_reshard_onto_a_requested_device(tmp_path):
    """The one-card reshard: a training checkpoint restored onto the
    device asked for; without a card, asking for one raises."""
    d = str(tmp_path / "ck")
    tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "2",
                  "--batch", "2", "--seq", "8", "--ckpt-dir", d,
                  "--device", "cpu"])
    state, step = treshard.reshard_state("tinyllama-1.1b", d, device="cpu",
                                         reduced=True)
    assert step == 2 and int(state["opt"]["step"]) == 2
    cfg = tget("tinyllama-1.1b").reduced(dtype="float32", remat=False)
    files = os.path.join(d, "step_00000002")
    want = naming.reference_state(cfg, _nested(
        {f[:-4]: np.load(os.path.join(files, f)) for f in os.listdir(files)
         if f.endswith(".npy")}, "params__"))
    for name, p in state["params"].named_parameters():
        assert p.device.type == "cpu" and p.dtype == torch.float32
        assert p.requires_grad
        assert np.array_equal(p.detach().numpy(), want[name]), name
    state2, _ = treshard.main(["--arch", "tinyllama-1.1b", "--reduced",
                               "--ckpt-dir", d, "--device", "cpu"])
    assert int(state2["opt"]["step"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            treshard.reshard_state("tinyllama-1.1b", d, reduced=True)


def test_quantize_error_feedback_converges():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    residual = {"g": torch.zeros(256)}
    total = torch.zeros(256)
    for _ in range(50):
        comp, residual = gc.ef_compress_grads({"g": g_true}, residual)
        total = total + comp["g"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(),
                               atol=2e-3)


def test_quantize_int8_range():
    x = torch.tensor([[-3.0, 0.0, 3.0]])
    q, s = gc.quantize_int8(x)
    assert q.dtype == torch.int8
    np.testing.assert_allclose(gc.dequantize(q, s).numpy(), x.numpy(),
                               atol=3.0 / 127 + 1e-6)


def test_compressed_pod_mean_matches_jax_mesh(jax_mesh):
    # the reference's case: the value replicated over 2 pods
    x = torch.linspace(-1, 1, 64).reshape(8, 8)
    out = gc.compressed_pod_mean({"g": torch.stack([x, x])})["g"]
    assert out.shape == (8, 8)
    np.testing.assert_allclose(out.numpy(), x.numpy(), atol=2 / 127)
    np.testing.assert_allclose(out.numpy(), jax_mesh["pod_mean"], rtol=0,
                               atol=1e-7)
    # pods that differ: the mean of their int8 payloads
    rng = np.random.default_rng(2)
    pods = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32))
    got = gc.compressed_pod_mean({"g": pods})["g"]
    scale = float(pods.abs().amax(dim=(1, 2)).max()) / 127
    np.testing.assert_allclose(got.numpy(), pods.mean(0).numpy(), rtol=0,
                               atol=scale)


# ---------------------------------------------------------------------------
# the optimizer and the compression against the JAX functions
# ---------------------------------------------------------------------------


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(3)
    shapes = {"a": (16, 8), "b": (8,), "c": (3, 4, 5)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=2.0)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: _t(v.copy()) for n, v in p0.items()}
    js, ts = jopt.init_opt_state(jp), init_opt_state(tp)
    for step in range(4):
        g = {n: rng.normal(size=s).astype(np.float32) * (step + 1)
             for n, s in shapes.items()}
        jp, js, jinfo = jopt.adamw_update(jp, {n: jnp.asarray(v)
                                               for n, v in g.items()},
                                          js, jopt.OptConfig(**kw))
        tp, ts, tinfo = adamw_update(tp, {n: _t(v) for n, v in g.items()},
                                     ts, OptConfig(**kw))
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]),
                                       rtol=1e-6)
        for n in shapes:
            for got, want in ((tp[n], jp[n]), (ts["mu"][n], js["mu"][n]),
                              (ts["nu"][n], js["nu"][n])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
    assert int(ts["step"]) == int(js["step"]) == 4


def test_grad_compression_matches_jax():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(64, 32)).astype(np.float32),
         "b": (rng.normal(size=(17,)) * 1e-3).astype(np.float32)}
    r = {n: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
         for n, v in g.items()}
    jq, js = jgc.quantize_int8(jnp.asarray(g["a"]))
    tq, ts = gc.quantize_int8(_t(g["a"]))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    jout, jres = jgc.ef_compress_grads({n: jnp.asarray(v) for n, v in g.items()},
                                       {n: jnp.asarray(v) for n, v in r.items()})
    tout, tres = gc.ef_compress_grads({n: _t(v) for n, v in g.items()},
                                      {n: _t(v) for n, v in r.items()})
    for n in g:
        np.testing.assert_allclose(tout[n].numpy(), np.asarray(jout[n]),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(tres[n].numpy(), np.asarray(jres[n]),
                                   rtol=0, atol=1e-7)
    init = gc.init_residual({"w": torch.ones((2, 3), dtype=torch.bfloat16)})
    assert init["w"].dtype == torch.float32 and not init["w"].any()


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _moe_reference_state():
    """A reduced qwen2-moe training state of the JAX package: its
    weights, moments drawn with numpy, step 5."""
    cfg = jget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False)
    params = japi.build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)

    def draw(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))

    return {"params": params,
            "opt": {"mu": jax.tree.map(draw, params),
                    "nu": jax.tree.map(draw, params),
                    "step": jnp.int32(5)}}


#: slice 7's families: one reduced arch each (xlstm down to its sLSTM
#: layer 5)
FAMILY_ARCHS = {"llava-next-34b": {}, "minicpm3-4b": {},
                "xlstm-125m": {"n_layers": 6}, "hymba-1.5b": {},
                "whisper-base": {}}


def _family_reference_state(arch):
    """A reduced training state of the JAX package for `arch`: its
    weights, moments drawn with numpy, step 3."""
    cfg = jget(arch).reduced(dtype="float32", remat=False,
                             **FAMILY_ARCHS[arch])
    params = jax.jit(japi.build(cfg).init)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def draw(p):
        return jnp.asarray(rng.normal(size=p.shape).astype(np.float32))

    return {"params": params,
            "opt": {"mu": jax.tree.map(draw, params),
                    "nu": jax.tree.map(draw, params),
                    "step": jnp.int32(3)}}


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_checkpoints_cross_between_the_packages(arch, tmp_path):
    """Each family's reference checkpoint (xlstm's list of layers as
    `blocks__<i>__<key>`, whisper's two stacks, hymba's `meta`, MLA's
    latent leaves) loads in the port with every value; the port writes it
    back with the same manifest (names, shapes, crc32s) and the reference
    loads that."""
    jstate = _family_reference_state(arch)
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jstate, d_ref, 3)
    cfg = tget(arch).reduced(dtype="float32", remat=False,
                             **FAMILY_ARCHS[arch])
    target = abstract_train_state(tapi.build(cfg), TrainConfig())
    assert sorted(ckpt.leaf_names(target)) == sorted(
        _manifest(d_ref, 3)["leaves"])
    state, step = ckpt.load(target, d_ref, device="cpu")
    assert step == 3 and int(state["opt"]["step"]) == 3
    want = {key: naming.reference_state(cfg, jax.tree.map(np.asarray, tree))
            for key, tree in (("params", jstate["params"]),
                              ("mu", jstate["opt"]["mu"]),
                              ("nu", jstate["opt"]["nu"]))}
    for name, p in state["params"].named_parameters():
        assert p.requires_grad and p.dtype == torch.float32
        assert np.array_equal(p.detach().numpy(), want["params"][name]), name
        for key in ("mu", "nu"):
            assert np.array_equal(state["opt"][key][name].numpy(),
                                  want[key][name])
    ckpt.save(state, d_port, 3)
    assert _manifest(d_port, 3) == _manifest(d_ref, 3)
    back, jstep = jckpt.load(jax.eval_shape(lambda: jstate), d_port)
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["xlstm-125m", "whisper-base"])
def test_grad_compression_scales_follow_the_reference_leaves(arch):
    """ef_compress_grads with one int8 scale per reference leaf: xlstm's
    layers each their own (a list in the reference), whisper's stacks
    one per key; the same outputs and residuals as the reference's on
    the same gradients, on the model's names."""
    cfg = tget(arch).reduced(dtype="float32", remat=False,
                             **FAMILY_ARCHS[arch])
    jparams = _family_reference_state(arch)["params"]
    rng = np.random.default_rng(9)
    g = jax.tree.map(lambda p: (rng.normal(size=p.shape) * rng.choice(
        [1e-3, 1.0])).astype(np.float32), jparams)
    r = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 1e-3).astype(
        np.float32), jparams)
    jout, jres = jgc.ef_compress_grads(jax.tree.map(jnp.asarray, g),
                                       jax.tree.map(jnp.asarray, r))
    model = tapi.build(cfg).init(None, trainable=True)
    tg, tr = (
        {n: _t(a) for n, a in naming.reference_state(cfg, tree).items()}
        for tree in (g, r))
    tout, tres = gc.ef_compress_grads(tg, tr, model.stacked)
    for key, got, want in (("out", tout, jout), ("res", tres, jres)):
        want = naming.reference_state(cfg, jax.tree.map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for n in got:
            np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0,
                                       atol=1e-7, err_msg=f"{key} {n}")


def test_checkpoints_cross_between_the_packages(tmp_path):
    """Written by the reference, loaded by the port, written again by the
    port, loaded by the reference: the same leaves, names and crc32s in
    both manifests, the same values everywhere."""
    jstate = _moe_reference_state()
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(jstate, d_ref, 5)
    cfg = tget("qwen2-moe-a2.7b").reduced(dtype="float32", remat=False)
    target = abstract_train_state(tapi.build(cfg), TrainConfig())
    state, step = ckpt.load(target, d_ref, device="cpu")
    assert step == 5 and int(state["opt"]["step"]) == 5
    want = {key: naming.reference_state(
        cfg, jax.tree.map(np.asarray, tree)) for key, tree in
        (("params", jstate["params"]), ("mu", jstate["opt"]["mu"]),
         ("nu", jstate["opt"]["nu"]))}
    for name, p in state["params"].named_parameters():
        assert p.requires_grad and p.dtype == torch.float32
        assert np.array_equal(p.detach().numpy(), want["params"][name]), name
        for key in ("mu", "nu"):
            assert np.array_equal(state["opt"][key][name].numpy(),
                                  want[key][name])
    ckpt.save(state, d_port, 5)
    assert _manifest(d_port, 5) == _manifest(d_ref, 5)
    back, jstep = jckpt.load(jax.eval_shape(lambda: jstate), d_port)
    assert jstep == 5
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_training_checkpoint_loads_in_the_reference(tmp_path):
    """A state the port trained: the reference restores it into its own
    abstract training state with the checksum gate on."""
    cfg = tget("tinyllama-1.1b").reduced(dtype="float32", remat=False)
    model = tapi.build(cfg)
    tcfg = TrainConfig()
    state = train_state_of(model.init(torch.Generator().manual_seed(1),
                                      trainable=True), tcfg)
    rng = np.random.default_rng(6)
    batch = {k: _t(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
             for k in ("tokens", "labels")}
    state, _ = make_train_step(model, tcfg)(state, batch)
    d = str(tmp_path / "ck")
    ckpt.save(state, d, 1)
    jcfg = jget("tinyllama-1.1b").reduced(dtype="float32", remat=False)
    jm = japi.build(jcfg)
    abstract = jax.eval_shape(lambda k: {
        "params": jm.init(k), "opt": jopt.init_opt_state(jm.init(k))},
        jax.random.PRNGKey(0))
    back, step = jckpt.load(abstract, d)
    assert step == 1 and int(back["opt"]["step"]) == 1
    got = naming.reference_state(cfg, jax.tree.map(np.asarray,
                                                        back["params"]))
    for name, p in state["params"].named_parameters():
        assert np.array_equal(got[name], p.detach().numpy()), name


# ---------------------------------------------------------------------------
# the drivers and the MoE example
# ---------------------------------------------------------------------------


def _train(*extra):
    return tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch",
                         "4", "--seq", "16", "--log-every", "1", "--device",
                         "cpu", *extra])


def test_train_driver_restart_matches_the_straight_run(tmp_path):
    d = str(tmp_path / "ck")
    straight = _train("--steps", "4")
    first = _train("--steps", "2", "--ckpt-dir", d)
    assert first["start"] == 0 and ckpt.latest_step(d) == 2
    resumed = _train("--steps", "4", "--ckpt-dir", d)
    assert resumed["start"] == 2 and resumed["load_s"] is not None
    assert sorted(resumed["losses"]) == [2, 3]
    for s in (0, 1):
        assert first["losses"][s] == straight["losses"][s]
    for s in (2, 3):
        assert resumed["losses"][s] == straight["losses"][s]
    assert resumed["loss"] == straight["loss"] and ckpt.latest_step(d) == 4
    assert all(np.isfinite(v) for v in straight["losses"].values())


def test_serve_driver_runs_on_the_cpu(capsys):
    argv = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--max-new", "4", "--device", "cpu"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a["tokens"].shape == (2, 4) and a["steps"] == 4
    assert torch.equal(a["tokens"], b["tokens"])
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_drivers_run_every_family_on_the_cpu(arch, capsys):
    """launch/serve.py and launch/train.py on slice 7's families (reduced):
    the same tokens twice from the same seeds, finite losses."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "9", "--max-new", "3", "--device", "cpu"]
    a, b = tserve.main(argv), tserve.main(argv)
    assert a["tokens"].shape == (2, 3) and torch.equal(a["tokens"],
                                                       b["tokens"])
    out = tlaunch.main(["--arch", arch, "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "12", "--log-every", "1",
                        "--device", "cpu"])
    assert sorted(out["losses"]) == [0, 1]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert "tok/s" in capsys.readouterr().out


def test_entry_points_run_on_the_card_unless_asked():
    from repro_torch.examples import train_moe

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    calls = [lambda: tlaunch.main(["--arch", "tinyllama-1.1b", "--reduced",
                                   "--steps", "1"]),
             lambda: tserve.main(["--arch", "tinyllama-1.1b", "--reduced"]),
             lambda: train_moe.main(["--steps", "1"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_train_moe_example_matches_jax_mesh(jax_mesh, tmp_path):
    """The example's first steps on the reference's weights: dp 2 x ep 4
    as a batch axis against the reference's 2x4 mesh of 8 devices."""
    from repro_torch.examples import train_moe

    cfg = train_moe.example_config()
    want_cfg = dataclasses.replace(
        jget("qwen2-moe-a2.7b"), n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=8, d_head=32, vocab=8192, n_experts=8, top_k=2,
        d_ff_expert=512, shared_d_ff=512, dispatch_impl="sort",
        moe_capacity_factor=2.0, dtype="float32", remat=False, attn_chunk=64,
        train_microbatches=1)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
    tree = _nested(jax_mesh, "param__")
    model = tapi.build(cfg, ep_size=train_moe.EP, dp=train_moe.DP)
    params = model.params_from_reference(tree, device="cpu", trainable=True)
    out = train_moe.main(["--steps", str(MOE_STEPS), "--batch",
                          str(MOE_BATCH), "--seq", str(MOE_SEQ), "--device",
                          "cpu", "--ckpt-dir", str(tmp_path / "ck")],
                         params=params)
    assert len(out["losses"]) == MOE_STEPS
    np.testing.assert_allclose(out["losses"], jax_mesh["moe_losses"],
                               rtol=0, atol=1e-4)


def test_pipeline_and_loss_shift_the_labels_twice():
    """ROADMAP.md §3 fault 5, kept as the reference has it: the pipeline
    already pairs tokens[i] with labels[i] = the next token, and the loss
    shifts once more, so logits at position i are scored against the
    token two ahead. Both packages compute the same number."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import TokenPipeline as JTokenPipeline
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    cfg = DataConfig(vocab=50, seq_len=6, global_batch=2, num_samples=64)
    batch = TokenPipeline(cfg, device="cpu").batch_at(3)
    jbatch = JTokenPipeline(JDataConfig(**dataclasses.asdict(cfg))).batch_at(3)
    for k in ("tokens", "labels"):
        assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
    toks = torch.cat([batch["tokens"], batch["labels"][:, -1:]], dim=1)
    logits = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, cfg.seq_len, 64)).astype(np.float32))
    two_ahead = torch.nn.functional.cross_entropy(
        logits[:, :-1].reshape(-1, 64), toks[:, 2:].reshape(-1).long())
    got = tapi.ce_loss(logits, batch["labels"])
    assert float(abs(got - two_ahead)) < 1e-6
    want = japi._ce_loss(jnp.asarray(logits.numpy()),
                         jnp.asarray(batch["labels"].numpy()))
    assert abs(float(got) - float(want)) < 1e-6


def test_loss_decreases_tinyllama():
    """Twin of tests/test_models.py: overfitting one batch for 15 steps
    brings the loss below 0.9 of its start."""
    cfg = tget("tinyllama-1.1b").reduced(dtype="float32", remat=False,
                                         n_layers=2, vocab=128)
    model = tapi.build(cfg)
    tcfg = TrainConfig(opt=OptConfig(peak_lr=3e-3, warmup_steps=2,
                                     total_steps=40))
    state = train_state_of(model.init(torch.Generator().manual_seed(0),
                                      trainable=True), tcfg)
    step = make_train_step(model, tcfg)
    rng = np.random.default_rng(0)
    batch = {k: _t(rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32))
             for k in ("tokens", "labels")}
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses
