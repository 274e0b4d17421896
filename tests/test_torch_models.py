"""The port's model side against the JAX package: the arch configs
(copies), the config twin, the dense and MoE transformers and the
serving engine.

Every comparison carries the JAX model's weights across with
`params_from_reference` (the port cannot reproduce JAX's PRNG), on the
reduced float32 configs the reference's own tests use; prompts are drawn
with numpy from a seed. The JAX models run in-process on one CPU device
(no mesh: the single-shard "dense" MoE dispatch). Bounds: logits within
1e-4 of JAX's (float32, the same math in another summation order; the
reference's MoE dispatch bound), prefill + decode_step within 5e-3 of
the full forward (tests/test_models.py's decode-parity bound), greedy
tokens equal.
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
from repro_torch.configs import get as tget
from repro_torch.models import api as tapi
from repro_torch.models import transformer
from repro_torch.serve import engine as tengine

torch.set_num_threads(2)

PORTED = ["tinyllama_1_1b", "granite_3_8b", "mistral_nemo_12b",
          "qwen2_moe_a2_7b", "moonshot_v1_16b_a3b"]
NOT_PORTED = [a for a in ARCH_IDS if a not in PORTED]
B, S, NEW = 2, 17, 8


def _reduced(get, arch, **over):
    return get(arch).reduced(dtype="float32", remat=False, **over)


class _Case:
    """One arch: the JAX model, its weights and outputs, and the port's
    model holding the same weights."""

    def __init__(self, arch, **over):
        self.jcfg, self.tcfg = _reduced(jget, arch, **over), \
            _reduced(tget, arch, **over)
        self.jm, self.tm = japi.build(self.jcfg), tapi.build(self.tcfg)
        self.jparams = self.jm.init(jax.random.PRNGKey(0))
        self.params = self.tm.params_from_reference(
            jax.tree.map(np.asarray, self.jparams), device="cpu")
        self.tokens = np.random.default_rng(0).integers(
            0, self.jcfg.vocab, (B, S)).astype(np.int32)
        self.jlogits = np.asarray(self.jm.forward(
            self.jparams, {"tokens": jnp.asarray(self.tokens)}))

    def batch(self, tokens=None):
        return {"tokens": torch.from_numpy(
            self.tokens if tokens is None else tokens)}


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
@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_config_arithmetic(arch, full):
    cfg = tget(arch) if full else _reduced(tget, arch)
    model = transformer.Transformer(cfg, None)  # shapes only, on "meta"
    count = sum(p.numel() for p in model.parameters())
    assert count == transformer.expected_param_count(cfg)
    if full and arch == "qwen2_moe_a2_7b":
        # 24 layers of 605 M (attention, 64 padded experts, shared
        # experts) plus the tied 152,064-row embedding
        assert 14.8e9 < count < 14.9e9


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
    assert got.shape == (B, S, c.tcfg.padded_vocab)
    assert float(np.abs(got.numpy() - c.jlogits).max()) < 1e-4


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_forward(arch):
    c = case(arch)
    full = c.tm.forward(c.params, c.batch()).numpy()
    lg_pre, cache = c.tm.prefill(c.params, c.batch(c.tokens[:, :S - 1]),
                                 max_len=S + 4)
    assert cache["k"].shape == (c.tcfg.n_layers, B, S + 4,
                                c.tcfg.n_kv_heads, c.tcfg.head_dim)
    assert float(np.abs(lg_pre[:, 0].numpy() - full[:, S - 2]).max()) < 5e-3
    lg_dec, _ = c.tm.decode_step(c.params, cache,
                                 torch.from_numpy(c.tokens[:, S - 1:]), S - 1)
    assert float(np.abs(lg_dec[:, 0].numpy() - full[:, -1]).max()) < 5e-3
    assert float(np.abs(lg_dec[:, 0].numpy() - c.jlogits[:, -1]).max()) < 5e-3


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_generate_matches_jax(arch):
    c = case(arch)
    want, jsteps = jengine.generate(
        c.jm, c.jparams, {"tokens": jnp.asarray(c.tokens)},
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
# what is not ported, and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_families_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tapi.build(_reduced(tget, arch))


def test_params_from_reference_checks_depth_and_needs_a_card():
    c = case("tinyllama_1_1b")
    tree = jax.tree.map(np.asarray, c.jparams)
    shallow = dataclasses.replace(c.tcfg, n_layers=1)
    with pytest.raises(ValueError, match="expected 1 layers"):
        tapi.build(shallow).params_from_reference(tree, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            c.tm.params_from_reference(tree)


def test_serve_decode_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_decode

    out = serve_decode.main(["--arch", "qwen2-moe-a2.7b", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4",
                             "--device", "cpu"])
    assert out["tokens"].shape == (2, 4) and out["steps"] == 4
    assert "decoded 8 tokens" in capsys.readouterr().out
