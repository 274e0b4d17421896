"""The port's model side against the JAX package: the arch configs
(copies), the config twin, every family's model (dense, MoE, VLM, MLA,
xLSTM, hymba, whisper) and the serving engine.

Every comparison carries the JAX model's weights across with
`params_from_reference` (the port cannot reproduce JAX's PRNG), on the
reduced float32 configs the reference's own tests use; prompts are drawn
with numpy from a seed. The JAX models run in-process on one CPU device
(no mesh: the single-shard "dense" MoE dispatch); on a config whose
experts are padded (every reduced MoE config: 8 experts in 16 columns)
the reference routes with its pad experts masked
(`test_torch_moe.masked_reference_router`: the port never routes to a
pad expert, ROADMAP.md §3 fault 4). Bounds: logits within
1e-4 of JAX's (float32, the same math in another summation order; the
reference's MoE dispatch bound), prefill + decode_step within 5e-3 of
the full forward (tests/test_models.py's decode-parity bound), greedy
tokens equal. A vlm case feeds patch embeddings and an encdec case
frames, drawn with numpy from the same seed. The family traps: xlstm
runs 6 layers (its reduced config keeps 2, short of the sLSTM layer
5); hymba's and whisper's prompts are 40 tokens (the ring of hymba's
reduced window of 32 wraps; whisper's encoder gets 10 frames, more than
the minimum of 8); hymba runs its real SSM heads against the reference
padded to `ssm_pad_heads`.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import REPO
from repro.configs import ARCH_IDS
from repro.configs import get as jget
from repro.models import api as japi
from repro.serve import engine as jengine
from repro.train import optimizer as jopt
from repro.train import train_step as jtrain
from repro_torch.configs import get as tget
from repro_torch.models import api as tapi
from repro_torch.models import naming, transformer
from repro_torch.serve import engine as tengine
from repro_torch.train import train_step as ttrain
from test_torch_moe import masked_reference_router

torch.set_num_threads(2)

#: the families of slices 5 and 6, and those of slice 7
DENSE_MOE = ["tinyllama_1_1b", "granite_3_8b", "mistral_nemo_12b",
             "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b"]
FAMILIES = ["llava_next_34b", "minicpm3_4b", "xlstm_125m", "hymba_1_5b",
            "whisper_base"]
PORTED = DENSE_MOE + FAMILIES
assert sorted(PORTED) == sorted(ARCH_IDS)
B, S, NEW = 2, 17, 8
#: per-arch overrides of the reduced config: xlstm down to its sLSTM
#: layer 5
OVER = {"xlstm_125m": {"n_layers": 6}}
#: per-arch prompt lengths: hymba's wraps its ring of 32, whisper's gets
#: more than 8 frames
SEQ = {"hymba_1_5b": 40, "whisper_base": 40}


def _reduced(get, arch, **over):
    return get(arch).reduced(dtype="float32", remat=False,
                             **{**OVER.get(arch, {}), **over})


class _Case:
    """One arch: the JAX model, its weights and outputs, and the port's
    model holding the same weights."""

    def __init__(self, arch, **over):
        self.jcfg, self.tcfg = _reduced(jget, arch, **over), \
            _reduced(tget, arch, **over)
        self.jm, self.tm = japi.build(self.jcfg), tapi.build(self.tcfg)
        # slice 7's families run the reference jit-compiled (the same
        # PRNG draws; their eager scans take seconds a call)
        self.jit = jax.jit if arch in FAMILIES else (lambda fn: fn)
        self.jparams = self.jit(self.jm.init)(jax.random.PRNGKey(0))
        self.params = self.tm.params_from_reference(
            jax.tree.map(np.asarray, self.jparams), device="cpu")
        self.s = SEQ.get(arch, S)
        # the text positions after a VLM prefix
        self.offset = self.jcfg.vlm_prefix if self.jcfg.family == "vlm" \
            else 0
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, self.jcfg.vocab,
                                   (B, self.s)).astype(np.int32)
        self.stubs = stub_arrays(self.jcfg, B, self.s, rng)
        with self.reference():
            self.jlogits = np.asarray(self.jit(self.jm.forward)(
                self.jparams, self.jbatch()))

    def reference(self):
        """The context every JAX run of this case is traced in."""
        return masked_reference_router(self.jcfg)

    def batch(self, tokens=None):
        return {"tokens": torch.from_numpy(
            self.tokens if tokens is None else tokens),
            **{k: torch.from_numpy(v) for k, v in self.stubs.items()}}

    def jbatch(self, tokens=None):
        return {"tokens": jnp.asarray(
            self.tokens if tokens is None else tokens),
            **{k: jnp.asarray(v) for k, v in self.stubs.items()}}


def stub_arrays(cfg, b, s, rng):
    """The frontend stubs' inputs, as tests/test_models.py's
    reduced_batch shapes them, drawn with numpy."""
    if cfg.family == "vlm":
        shape = {"patch_embeds": (b, cfg.vlm_prefix, cfg.d_model)}
    elif cfg.family == "encdec":
        shape = {"frames": (b, max(s // 4, 8), cfg.d_model)}
    else:
        shape = {}
    return {k: rng.normal(size=v).astype(np.float32)
            for k, v in shape.items()}


_CASES: dict = {}


def case(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _CASES:
        _CASES[key] = _Case(arch, **over)
    return _CASES[key]


# ---------------------------------------------------------------------------
# configs: copies of the reference, and the config twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS + ["__init__"])
def test_copied_config_modules_are_the_reference_renamed(arch):
    rel = os.path.join("configs", f"{arch}.py")
    with open(os.path.join(REPO, "src", "repro", rel)) as f:
        want = f.read().replace("repro.", "repro_torch.")
    with open(os.path.join(REPO, "src", "repro_torch", rel)) as f:
        assert f.read() == want, rel


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_get_resolves_every_name(arch):
    want = jget(arch)
    for name in (arch, arch.replace("_", "-"), want.name):
        got = tget(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for prop in ("head_dim", "padded_vocab", "n_experts_padded",
                     "is_moe", "is_encdec", "supports_long_context"):
            assert getattr(got, prop) == getattr(want, prop), prop
        assert got.params_dense() == want.params_dense()
        assert got.params_active() == want.params_active()
        assert (dataclasses.asdict(got.reduced(dtype="float32"))
                == dataclasses.asdict(want.reduced(dtype="float32")))
    assert tget(arch).compute_dtype == torch.bfloat16
    assert tget(arch).reduced(dtype="float32").compute_dtype == torch.float32


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", DENSE_MOE)
def test_param_count_matches_config_arithmetic(arch, full):
    cfg = tget(arch) if full else _reduced(tget, arch)
    model = transformer.Transformer(cfg, None)  # shapes only, on "meta"
    count = sum(p.numel() for p in model.parameters())
    assert count == transformer.expected_param_count(cfg)
    if full and arch == "qwen2_moe_a2_7b":
        # 24 layers of 605 M (attention, 64 padded experts, shared
        # experts) plus the tied 152,064-row embedding
        assert 14.8e9 < count < 14.9e9


class _Shape:
    """A leaf's shape standing in for the leaf (a layer slice drops the
    leading axis)."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __getitem__(self, i):
        return _Shape(self.shape[1:])


def _shapes(tree):
    """{dotted path: (shape, dtype name)} of a cache of dicts and lists."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in naming.flatten(tree).items()}


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_count_matches_the_reference_leaves(arch, full):
    """`params_dense()` only approximates the ssm, hybrid and encdec
    families (config.py), so the count is held to the sum of the
    reference's abstract_params leaf sizes, leaf by leaf; for the
    transformer families to the config's arithmetic too."""
    jcfg, tcfg = (jget(arch), tget(arch)) if full else \
        (_reduced(jget, arch), _reduced(tget, arch))
    model = tapi.model_class(tcfg)(tcfg, None)  # shapes only, on "meta"
    want = naming.reference_state(tcfg, jax.tree.map(
        lambda a: _Shape(a.shape), japi.build(jcfg).abstract_params()))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for name, p in got.items():
        assert tuple(p.shape) == tuple(want[name].shape), name
    count = sum(p.numel() for p in got.values())
    if tcfg.family in transformer.FAMILIES:
        assert count == transformer.expected_param_count(tcfg)
    if full and arch == "llava_next_34b":
        assert 33.9e9 < count < 34.0e9  # 67.9 GB of bfloat16 weights


# ---------------------------------------------------------------------------
# the models against JAX on the same weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,over", [(a, {}) for a in PORTED] + [
    ("qwen2_moe_a2_7b", {"dispatch_impl": "onehot"})],
    ids=PORTED + ["qwen2_moe_a2_7b-onehot"])
def test_forward_matches_jax(arch, over):
    c = case(arch, **over)
    got = c.tm.forward(c.params, c.batch())
    assert got.dtype == torch.float32
    assert got.shape == (B, c.offset + c.s, c.tcfg.padded_vocab)
    assert float(np.abs(got.numpy() - c.jlogits).max()) < 1e-4


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_forward(arch):
    """prefill of all but the last token, then one decode step, against
    the full forward (for MLA: the absorbed decode against the expanded
    forward); the cache has the reference's structure and shapes."""
    c = case(arch)
    s, off = c.s, c.offset
    full = c.tm.forward(c.params, c.batch()).numpy()
    lg_pre, cache = c.tm.prefill(c.params, c.batch(c.tokens[:, :s - 1]),
                                 max_len=s + 4)
    with c.reference():
        want = jax.eval_shape(lambda: c.jm.prefill(
            c.jparams, c.jbatch(c.tokens[:, :s - 1]), max_len=s + 4)[1])
    assert _shapes(cache) == _shapes(want)
    assert float(np.abs(lg_pre[:, 0].numpy()
                        - full[:, off + s - 2]).max()) < 5e-3
    lg_dec, _ = c.tm.decode_step(c.params, cache,
                                 torch.from_numpy(c.tokens[:, s - 1:]),
                                 off + s - 1)
    assert float(np.abs(lg_dec[:, 0].numpy() - full[:, -1]).max()) < 5e-3
    assert float(np.abs(lg_dec[:, 0].numpy() - c.jlogits[:, -1]).max()) < 5e-3


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_generate_matches_jax(arch):
    c = case(arch)
    jm = c.jm
    if arch in FAMILIES:  # the reference's prefill jit-compiled too
        jm = dataclasses.replace(jm, prefill=jax.jit(
            jm.prefill, static_argnames="max_len"))
    with c.reference():
        want, jsteps = jengine.generate(
            jm, c.jparams, c.jbatch(),
            jengine.ServeConfig(max_new_tokens=NEW))
    got, steps = tengine.generate(c.tm, c.params, c.batch(),
                                  tengine.ServeConfig(max_new_tokens=NEW))
    assert got.dtype == torch.int32 and steps == jsteps == NEW
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_generate_stops_at_eos_like_jax():
    c = case("qwen2_moe_a2_7b")
    free, _ = tengine.generate(c.tm, c.params, c.batch(),
                               tengine.ServeConfig(max_new_tokens=NEW))
    eos = int(free[0, 2])  # row 0 stops after its third token
    cfg = dict(max_new_tokens=NEW, eos_id=eos)
    with c.reference():
        want, _ = jengine.generate(c.jm, c.jparams,
                                   {"tokens": jnp.asarray(c.tokens)},
                                   jengine.ServeConfig(**cfg))
    stats = {}
    got, _ = tengine.generate(c.tm, c.params, c.batch(),
                              tengine.ServeConfig(**cfg), stats=stats)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 3:] == 0).all()
    assert stats["prefill_s"] > 0 and len(stats["decode_s"]) == NEW


def test_temperature_sampling_follows_the_generator():
    c = case("tinyllama_1_1b")
    cfg = tengine.ServeConfig(max_new_tokens=NEW, temperature=1.0)

    def draw(seed):
        return tengine.generate(
            c.tm, c.params, c.batch(), cfg,
            generator=torch.Generator().manual_seed(seed))[0]

    a, b = draw(7), draw(7)
    assert torch.equal(a, b)
    assert ((a >= 0) & (a < c.tcfg.padded_vocab)).all()
    assert not all(torch.equal(a, draw(s)) for s in range(8, 12))


def test_decode_position_outside_the_cache_raises():
    c = case("tinyllama_1_1b")
    _, cache = c.tm.prefill(c.params, c.batch(), max_len=S)
    with pytest.raises(IndexError, match="outside the cache"):
        c.tm.decode_step(c.params, cache,
                         torch.from_numpy(c.tokens[:, :1]), S)


# ---------------------------------------------------------------------------
# training: the loss, one train step and microbatches against JAX
# ---------------------------------------------------------------------------

# (arch, config overrides, TrainConfig overrides): every ported arch, the
# MoE archs with the sort and the onehot dispatch, and the error-feedback
# compression path
TRAIN_CASES = {
    "tinyllama_1_1b": ("tinyllama_1_1b", {}, {}),
    "granite_3_8b": ("granite_3_8b", {}, {}),
    "mistral_nemo_12b": ("mistral_nemo_12b", {}, {}),
    "qwen2_moe_a2_7b-sort": ("qwen2_moe_a2_7b", {"dispatch_impl": "sort"}, {}),
    "qwen2_moe_a2_7b-onehot": ("qwen2_moe_a2_7b", {"dispatch_impl": "onehot"},
                               {}),
    "moonshot_v1_16b_a3b-sort": ("moonshot_v1_16b_a3b",
                                 {"dispatch_impl": "sort"}, {}),
    "moonshot_v1_16b_a3b-onehot": ("moonshot_v1_16b_a3b",
                                   {"dispatch_impl": "onehot"}, {}),
    "tinyllama_1_1b-ef": ("tinyllama_1_1b", {}, {"pod_grad_compress": True}),
    **{arch: (arch, {}, {}) for arch in FAMILIES},
}


def _train_batch(cfg, b=4, s=16, seed=1):
    """Tokens and labels, and the frontend stubs' inputs: a vlm's labels
    span its prefix and the text (tests/test_models.py's reduced_batch)."""
    rng = np.random.default_rng(seed)
    prefix = cfg.vlm_prefix if cfg.family == "vlm" else 0
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab,
                                   (b, prefix + s)).astype(np.int32),
            **stub_arrays(cfg, b, s, rng)}


def _jax_step(c, batch, **tover):
    """One reference train step from the case's weights (the masked
    router inside): (new state, metrics)."""
    tcfg = jtrain.TrainConfig(**tover)
    state = {"params": c.jparams, "opt": jopt.init_opt_state(c.jparams)}
    if tcfg.pod_grad_compress:
        from repro.train import grad_compress as jgc
        state["ef_residual"] = jgc.init_residual(c.jparams)
    with c.reference():
        return c.jit(jtrain.make_train_step(c.jm, tcfg))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})


def _torch_step(c, batch, **tover):
    tcfg = ttrain.TrainConfig(**tover)
    params = c.tm.params_from_reference(jax.tree.map(np.asarray, c.jparams),
                                        device="cpu", trainable=True)
    state = ttrain.train_state_of(params, tcfg)
    return ttrain.make_train_step(c.tm, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_states_close(c, got, want, keys=("mu",)):
    """Parameters at rtol 2e-4 / atol 2e-5 (tests/test_models.py's
    bounds); the first moments, 0.1 x the clipped gradients, at rtol
    1e-3 / atol 1e-4 of the leaf's largest (float32 sums in another
    order); the error-feedback residual, at most half an int8 step, at
    atol 1e-3 of its largest (the gradients' float32 differences, passed
    on)."""
    ref = naming.reference_state(c.tcfg, jax.tree.map(np.asarray,
                                                      want["params"]))
    for name, p in got["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    for key in keys:
        tree = want["opt"][key] if key in ("mu", "nu") else want[key]
        ref = naming.reference_state(c.tcfg, jax.tree.map(np.asarray, tree))
        mine = got["opt"][key] if key in ("mu", "nu") else got[key]
        share = 1e-4 if key == "mu" else 1e-3
        for name, arr in ref.items():
            np.testing.assert_allclose(
                mine[name].numpy(), arr, rtol=1e-3,
                atol=share * float(np.abs(arr).max()) + 1e-12,
                err_msg=f"{key} {name}")


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_loss_and_train_step_match_jax(name):
    arch, over, tover = TRAIN_CASES[name]
    c = case(arch, **over)
    batch = _train_batch(c.tcfg)
    with c.reference():
        jloss = float(c.jit(c.jm.loss)(
            c.jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    params = c.tm.params_from_reference(jax.tree.map(np.asarray, c.jparams),
                                        device="cpu", trainable=True)
    tloss = c.tm.loss(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    assert tloss.dtype == torch.float32 and tloss.requires_grad
    assert abs(float(tloss.detach()) - jloss) < 1e-4
    want, jm = _jax_step(c, batch, **tover)
    got, tm = _torch_step(c, batch, **tover)
    assert abs(float(tm["loss"]) - float(jm["loss"])) < 1e-4
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(got["opt"]["step"]) == 1
    _assert_states_close(c, got, want, ("mu", "ef_residual")
                         if tover else ("mu",))


def test_microbatched_step_matches_the_full_step_and_jax():
    """tests/test_models.py's microbatch test on the port, and the port's
    microbatched step against the reference's."""
    c = case("tinyllama_1_1b", n_layers=2, vocab=64)
    batch = _train_batch(c.tcfg, s=16, seed=2)
    one, m1 = _torch_step(c, batch)
    four, m4 = _torch_step(c, batch, microbatches=4)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-4
    p1 = dict(one["params"].named_parameters())
    for name, p in four["params"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   p1[name].detach().numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    want, jm4 = _jax_step(c, batch, microbatches=4)
    assert abs(float(m4["loss"]) - float(jm4["loss"])) < 1e-4
    _assert_states_close(c, four, want)


def test_trainable_model_holds_float32_masters():
    """Training: float32 masters with gradients, cast to the compute dtype
    at use (bf16 here), float32 gradients back; serving: the config's
    dtype without gradients."""
    cfg = tget("qwen2_moe_a2_7b").reduced(dtype="bfloat16", remat=False)
    model = tapi.build(cfg)
    gen = torch.Generator().manual_seed(3)
    train = model.init(gen, trainable=True)
    serve = model.init(torch.Generator().manual_seed(3))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in serve.parameters())
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg).items()}
    logits = model.forward(train, batch)
    assert logits.dtype == torch.float32 and logits.requires_grad
    model.loss(train, batch).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in train.parameters())
    assert not model.forward(serve, batch).requires_grad


def test_remat_recomputes_the_same_gradients():
    c = case("qwen2_moe_a2_7b")
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(c.tcfg).items()}
    grads = {}
    for remat in (False, True):
        cfg = dataclasses.replace(c.tcfg, remat=remat)
        model = tapi.build(cfg)
        params = model.params_from_reference(
            jax.tree.map(np.asarray, c.jparams), device="cpu",
            trainable=True)
        model.loss(params, batch).backward()
        grads[remat] = {n: p.grad for n, p in params.named_parameters()}
    for name, g in grads[True].items():
        assert torch.equal(g, grads[False][name]), name


def test_mesh_model_matches_the_single_shard_model():
    """build(cfg, ep_size=4, dp=2) routes training tokens through the
    sharded sort dispatch and a decode step through ep_replicated; with
    capacity to spare both compute what the single-shard model does."""
    c = case("qwen2_moe_a2_7b", dispatch_impl="sort")
    tree = jax.tree.map(np.asarray, c.jparams)
    mesh = tapi.build(c.tcfg, ep_size=4, dp=2)
    single = tapi.build(c.tcfg)
    pm = mesh.params_from_reference(tree, device="cpu", trainable=True)
    ps = single.params_from_reference(tree, device="cpu", trainable=True)
    tokens = torch.from_numpy(c.tokens[:, :16])  # 32 tokens over 8 shards
    lm = mesh.forward(pm, {"tokens": tokens})
    ls = single.forward(ps, {"tokens": tokens})
    assert float((lm - ls).detach().abs().max()) < 1e-5
    lm.square().mean().backward()
    ls.square().mean().backward()
    gs = dict(ps.named_parameters())
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gs[name].grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    # prefill of 2 x 12 tokens over the 8 shards, then one decode step
    _, cm = mesh.prefill(pm, {"tokens": tokens[:, :12]}, max_len=16)
    _, cs = single.prefill(ps, {"tokens": tokens[:, :12]}, max_len=16)
    dm, _ = mesh.decode_step(pm, cm, tokens[:, 12:13], 12)
    ds, _ = single.decode_step(ps, cs, tokens[:, 12:13], 12)
    assert float((dm - ds).abs().max()) < 1e-5
    assert float((dm[:, 0] - ls[:, 12].detach()).abs().max()) < 5e-3


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_moe_a2_7b"]
                         + FAMILIES)
def test_init_cache_matches_jax(arch):
    """The same structure, shapes, dtypes and values (zeros, and the
    sLSTM normalizer's ones); whisper's cross cache holds
    enc_len_for(max_len) frames."""
    c = case(arch)
    want = jax.tree.map(np.asarray, c.jm.init_cache(B, S))
    got = c.tm.init_cache(B, S, device="cpu")
    assert _shapes(got) == _shapes(want)
    flat = naming.flatten(want)
    for name, t in naming.flatten(got).items():
        assert np.array_equal(t.numpy(), flat[name]), name


# ---------------------------------------------------------------------------
# the families' traps
# ---------------------------------------------------------------------------


def test_xlstm_case_reaches_an_slstm_layer():
    from repro_torch.models import xlstm

    c = case("xlstm_125m")
    assert xlstm.slstm_layers(c.tcfg) == (5,)
    assert c.s % c.tcfg.chunk != 0  # a ragged last chunk
    assert [type(b) for b in c.jparams["blocks"]] == [dict] * 6
    assert "r_gates" in c.jparams["blocks"][5]


def test_whisper_encoder_takes_more_than_the_minimum_frames():
    c = case("whisper_base")
    assert c.stubs["frames"].shape[1] == 10 > 8
    cache = c.tm.init_cache(B, 64, device="cpu")
    assert cache["xk"].shape[2] == 16  # api.init_cache: enc_len_for(64)


def test_hymba_ring_wraps_in_prefill_and_decode():
    """A 40-token prompt over hymba's reduced window of 32 (plus 8 meta
    tokens), then 16 decode steps, each against the reference's decode
    loop on the same tokens: the SWA ring wraps during prefill and again
    during decode; layer 0 is global (a full cache)."""
    c = case("hymba_1_5b")
    cfg = c.tcfg
    assert c.s > cfg.window and cfg.global_layers == (0,)
    steps = 16
    extra = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, steps)).astype(np.int32)
    max_len = c.s + steps
    jlg, jcache = jax.jit(lambda p, b: c.jm.prefill(p, b, max_len=max_len))(
        c.jparams, c.jbatch())
    jdecode = jax.jit(c.jm.decode_step)
    lg, cache = c.tm.prefill(c.params, c.batch(), max_len=max_len)
    assert cache[1]["k"].shape[1] == cfg.window + cfg.meta_tokens
    assert cache[0]["k"].shape[1] == max_len + cfg.meta_tokens
    assert float(np.abs(lg.numpy() - np.asarray(jlg)).max()) < 1e-4
    for i in range(steps):
        tok = extra[:, i:i + 1]
        jlg, jcache = jdecode(c.jparams, jcache, jnp.asarray(tok),
                              jnp.int32(c.s + i))
        lg, cache = c.tm.decode_step(c.params, cache, torch.from_numpy(tok),
                                     c.s + i)
        assert float(np.abs(lg.numpy() - np.asarray(jlg)).max()) < 1e-4, i
    for mine, ref in zip(cache, jcache):
        for key in ("k", "v", "s", "n", "conv"):
            np.testing.assert_allclose(mine[key].numpy(),
                                       np.asarray(ref[key]), rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def test_hymba_real_heads_match_the_padded_reference():
    """The reference pads the reduced config's 4 SSM heads to 32
    (`ssm_pad_heads`); the port runs the 4. Both references, padded and
    not, give the port's logits."""
    c = case("hymba_1_5b")
    n_ssm = c.tcfg.d_model // c.tcfg.head_dim
    assert c.jcfg.ssm_pad_heads == 32 > n_ssm
    unpadded = japi.build(dataclasses.replace(c.jcfg, ssm_pad_heads=0))
    want = np.asarray(jax.jit(unpadded.forward)(c.jparams, c.jbatch()))
    got = c.tm.forward(c.params, c.batch()).numpy()
    assert float(np.abs(got - want).max()) < 1e-4
    assert float(np.abs(got - c.jlogits).max()) < 1e-4


def test_hymba_prompt_longer_than_the_cache_raises():
    """The reference's prefill truncates a global layer's cache to
    max_len + meta when the prompt is longer (ROADMAP.md §3 fault 6);
    the port raises, and a decode position past a global layer's cache
    raises too."""
    c = case("hymba_1_5b")
    with pytest.raises(ValueError, match="does not fit"):
        c.tm.prefill(c.params, c.batch(), max_len=c.s - 1)
    _, cache = c.tm.prefill(c.params, c.batch(), max_len=c.s)
    with pytest.raises(IndexError, match="outside the cache"):
        c.tm.decode_step(c.params, cache, torch.from_numpy(c.tokens[:, :1]),
                         c.s)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "whisper_base"])
def test_decode_position_outside_the_family_cache_raises(arch):
    c = case(arch)
    _, cache = c.tm.prefill(c.params, c.batch(), max_len=c.s)
    with pytest.raises(IndexError, match="outside the cache"):
        c.tm.decode_step(c.params, cache, torch.from_numpy(c.tokens[:, :1]),
                         c.s)


# ---------------------------------------------------------------------------
# an unknown family, and the device rule
# ---------------------------------------------------------------------------


def test_unknown_family_raises_value_error():
    """As the reference's build (models/api.py): no family is left
    unported, and an unknown one is a ValueError."""
    cfg = dataclasses.replace(_reduced(tget, "tinyllama_1_1b"),
                              family="rnn")
    with pytest.raises(ValueError, match="unknown family rnn"):
        tapi.build(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        japi.build(dataclasses.replace(_reduced(jget, "tinyllama_1_1b"),
                                       family="rnn"))


def test_params_from_reference_checks_depth_and_needs_a_card():
    c = case("tinyllama_1_1b")
    tree = jax.tree.map(np.asarray, c.jparams)
    shallow = dataclasses.replace(c.tcfg, n_layers=1)
    with pytest.raises(ValueError, match="expected 1 layers"):
        tapi.build(shallow).params_from_reference(tree, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            c.tm.params_from_reference(tree)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llava-next-34b",
                                  "minicpm3-4b", "xlstm-125m", "hymba-1.5b",
                                  "whisper-base"])
def test_serve_decode_example_runs_on_the_cpu(arch, capsys):
    from repro_torch.examples import serve_decode

    out = serve_decode.main(["--arch", arch, "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4",
                             "--device", "cpu"])
    assert out["tokens"].shape == (2, 4) and out["steps"] == 4
    assert "decoded 8 tokens" in capsys.readouterr().out
