"""The port's op counter (launch/op_cost.py) against the reference's HLO
cost analysis (launch/hlo_cost.py).

The reference counts the optimized HLO of a jit-compiled program; the
port counts the aten ops an eager run dispatches. Inputs are drawn with
numpy from a seed (the counts depend on shapes only, so the port also
runs on "meta" tensors, and must count the same there as on the CPU).

- Loop-free programs (one matmul, one convolution, tanh(x @ w) + b, a
  row reduction): FLOPs and transcendentals equal the reference's
  exactly. The row reductions are at most 32 wide: XLA's CPU backend
  splits a longer row into a reduce-window, which the reference's
  analysis does not count (a 64-wide row sum of 64 rows counts 128 FLOPs
  there, 4,096 here), so past 32 the reference undercounts.
- A loop of L identical layers counts L times one layer, the reference's
  trip weighting; the reference also counts its scan's counter (an add
  and a compare a trip), which an eager loop does not run.
- A reduced forward of each family (B = 2, S = 64, float32) lands within
  2% of the reference's FLOPs. The ops outside the matmuls differ
  between the packages' implementations (the port's attention and
  state-space loops make fewer elementwise passes), so the elementwise
  counts are close, not equal. hymba runs against the reference with its
  SSM pad heads equal to the real heads (the reduced reference pads 4
  heads to 32, and the port runs the real heads). whisper's count was
  10.7% over while its decoder's cross-attention projected keys and
  values of the decoder states and threw them away, work the reference's
  XLA removes as dead code; the port projects only the queries
  (models/whisper._cross_q), and its count lands within 2%.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import hlo_cost
from repro.models import api as japi
from repro.models import whisper as jwhisper
from repro_torch.configs import get as tget
from repro_torch.launch import op_cost
from repro_torch.models import api as tapi

torch.set_num_threads(2)


def _reference(f, *arrays) -> dict:
    specs = [jax.ShapeDtypeStruct(a.shape, a.dtype) for a in arrays]
    return hlo_cost.analyze(jax.jit(f).lower(*specs).compile().as_text())


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32) for s in shapes]


LOOP_FREE = {
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b,
               [(64, 96), (96, 48)]),
    "conv2d": (lambda a, k: jax.lax.conv_general_dilated(a, k, (1, 1),
                                                         "SAME"),
               lambda a, k: torch.nn.functional.conv2d(a, k, padding=1),
               [(2, 8, 16, 16), (12, 8, 3, 3)]),
    "conv1d_strided": (lambda a, k: jax.lax.conv_general_dilated(
        a, k, (2,), "VALID"),
        lambda a, k: torch.nn.functional.conv1d(a, k, stride=2),
        [(2, 8, 40), (16, 8, 3)]),
    "tanh_affine": (lambda x, w, b: jnp.tanh(x @ w) + b,
                    lambda x, w, b: torch.tanh(x @ w) + b,
                    [(64, 96), (96, 48), (48,)]),
    "row_sum_8": (lambda a: a.sum(axis=1), lambda a: a.sum(dim=1),
                  [(64, 8)]),
    "row_sum_32": (lambda a: a.sum(axis=1), lambda a: a.sum(dim=1),
                   [(64, 32)]),
    "row_max_32": (lambda a: a.max(axis=1), lambda a: a.amax(dim=1),
                   [(64, 32)]),
}


@pytest.mark.parametrize("name", sorted(LOOP_FREE))
def test_loop_free_counts_equal_the_reference(name):
    jf, tf, shapes = LOOP_FREE[name]
    arrays = _arrays(*shapes)
    want = _reference(jf, *[jnp.asarray(a) for a in arrays])
    got = op_cost.analyze(tf, *[torch.from_numpy(a) for a in arrays])
    assert got["flops"] == want["flops"]
    assert got["transcendentals"] == want["transcendentals"]


@pytest.mark.parametrize("length", [4, 22])
def test_a_loop_counts_each_iteration(length):
    n = 128

    def scanned(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
        return y

    def loop(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    x, ws = _arrays((n, n), (length, n, n))
    want = _reference(scanned, jnp.asarray(x), jnp.asarray(ws))
    got = op_cost.analyze(loop, torch.from_numpy(x), torch.from_numpy(ws))
    one = op_cost.analyze(loop, torch.from_numpy(x),
                          torch.from_numpy(ws[:1]))
    assert got["flops"] == length * one["flops"]
    assert got["transcendentals"] == length * one["transcendentals"]
    assert max(want["while_trips"].values()) == length
    assert got["transcendentals"] == want["transcendentals"]
    assert want["flops"] - got["flops"] == 2 * length  # the scan's counter


def test_bytes_count_operands_and_outputs_of_kernels_only():
    a, b = (torch.from_numpy(x) for x in _arrays((64, 96), (96, 48)))
    got = op_cost.analyze(lambda a, b: (a @ b).t()[None, 1:], a, b)
    assert got["bytes"] == 4 * (64 * 96 + 96 * 48 + 64 * 48)
    assert got["by_op"]["mm"] == {"count": 1, "flops": 2 * 64 * 96 * 48,
                                  "bytes": got["bytes"],
                                  "transcendentals": 0}


B, S = 2, 64
#: one arch of each family
FAMILY_ARCH = {"dense": "tinyllama_1_1b", "moe": "qwen2_moe_a2_7b",
               "mla": "minicpm3_4b", "vlm": "llava_next_34b",
               "ssm": "xlstm_125m", "hybrid": "hymba_1_5b",
               "encdec": "whisper_base"}


def _family_counts(arch, device="meta"):
    """(reference, port) counts of one reduced float32 forward."""
    over = dict(dtype="float32", remat=False)
    jcfg, tcfg = jget(arch).reduced(**over), tget(arch).reduced(**over)
    if jcfg.family == "hybrid":  # the real SSM heads, unpadded
        jcfg = dataclasses.replace(
            jcfg, ssm_pad_heads=jcfg.d_model // jcfg.head_dim)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    specs = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
    if jcfg.family == "vlm":
        shape = (B, jcfg.vlm_prefix, jcfg.d_model)
        specs["patch_embeds"] = jax.ShapeDtypeStruct(shape, jnp.float32)
        batch["patch_embeds"] = torch.zeros(shape)
    if jcfg.family == "encdec":
        shape = (B, jwhisper.enc_len_for(jcfg, S), jcfg.d_model)
        specs["frames"] = jax.ShapeDtypeStruct(shape, jnp.float32)
        batch["frames"] = torch.zeros(shape)
    text = jax.jit(jm.forward).lower(jm.abstract_params(),
                                     specs).compile().as_text()
    want = hlo_cost.analyze(text)
    params = tm.init(None if device == "meta"
                     else torch.Generator().manual_seed(0))
    got = op_cost.analyze(tm.forward, params,
                          {k: v.to(device) for k, v in batch.items()})
    return want, got


@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_family_forward_flops_within_two_percent(family):
    want, got = _family_counts(FAMILY_ARCH[family])
    assert got["flops"] == pytest.approx(want["flops"], rel=0.02)
    assert got["transcendentals"] == pytest.approx(want["transcendentals"],
                                                   rel=0.02)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "whisper-base"])
def test_meta_and_cpu_tensors_count_the_same(arch):
    cfg = tget(arch).reduced(dtype="float32")
    model = tapi.build(cfg)
    counts = {}
    for device in ("cpu", "meta"):
        gen = torch.Generator().manual_seed(0) if device == "cpu" else None
        params = model.init(gen, trainable=True)
        batch = {"tokens": torch.zeros((B, 16), dtype=torch.int64),
                 "labels": torch.zeros((B, 16), dtype=torch.int64)}
        batch.update(tapi.stub_inputs(cfg, B, 16,
                                      torch.Generator().manual_seed(1)))
        batch = {k: v.to(device) for k, v in batch.items()}

        def step(params, batch):
            model.loss(params, batch).backward()

        counts[device] = op_cost.analyze(step, params, batch)
    assert counts["meta"] == counts["cpu"]
    # the backward pass is counted: its matmuls cost about twice the
    # forward's
    fwd = op_cost.analyze(model.forward, model.init(None), {
        k: v.to("meta") for k, v in batch.items()})
    assert counts["cpu"]["flops"] > 2.5 * fwd["flops"]
