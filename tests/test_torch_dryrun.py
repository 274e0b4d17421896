"""The port's one-card dry run (launch/dryrun.py) and the shape cells and
"meta" input specs of models/api.py, against the JAX package's.

- `SHAPES` and `applicable_shapes` equal the reference's.
- `input_specs` gives the reference's shapes and dtypes for every arch x
  applicable shape at full width, the decode cache compared leaf by leaf
  through models/naming.flatten (hymba against the reference with its
  SSM pad heads equal to the real heads, which the port runs).
- `peak_bytes` gives the analytic answer on a hand-built chain of
  allocations and frees, and equals itself on "meta" and on CPU tensors
  for a reduced train step and a reduced generate call.
- `run_cell` writes a record with the reference's keys and the one-card
  keys (fits, max_batch).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get as jget
from repro.models import api as japi
from repro_torch.configs import get as tget
from repro_torch.launch import dryrun
from repro_torch.models import api as tapi
from repro_torch.models import naming
from repro_torch.serve.engine import ServeConfig, generate
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          make_train_step)

torch.set_num_threads(2)


def test_shape_cells_equal_the_reference():
    assert tapi.SHAPES == japi.SHAPES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_shapes_equal_the_reference(arch):
    assert tapi.applicable_shapes(tget(arch)) == \
        japi.applicable_shapes(jget(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    if jcfg.family == "hybrid":  # the real SSM heads, unpadded
        jcfg = dataclasses.replace(
            jcfg, ssm_pad_heads=jcfg.d_model // jcfg.head_dim)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    for shape in japi.applicable_shapes(jcfg):
        want = naming.flatten(jm.input_specs(shape))
        got = naming.flatten(tm.input_specs(shape))
        assert sorted(got) == sorted(want), shape
        for name, spec in want.items():
            if name == "pos":  # a Python int here: decode calls int(pos)
                assert isinstance(got[name], int)
                assert 0 <= got[name] < japi.SHAPES[shape]["seq"]
                continue
            t = got[name]
            assert t.device.type == "meta", (shape, name)
            assert tuple(t.shape) == tuple(spec.shape), (shape, name)
            assert str(t.dtype) == f"torch.{spec.dtype}", (shape, name)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_peak_bytes_of_a_chain_of_frees(device):
    def empty(n):
        return torch.empty(n, dtype=torch.uint8, device=device)

    held = [empty(2048)]

    def chain(held):
        a = empty(1024)  # 1024 + the 2048 held
        b = empty(100)  # rounds up to 512
        held.pop()  # the held 2048 go: 1536 live
        c = empty(4096)  # 5632
        d = c[1:]  # a view: nothing new
        del a, b  # 4096
        e = d.float()  # 4095 floats, 16384: 20480, the peak
        del c, d, e  # 0
        return empty(512)  # 512

    assert dryrun.live_bytes(held) == 2048
    assert dryrun.peak_bytes(chain, held) == 20480
    assert dryrun.peak_bytes(lambda: empty(513)) == 1024


def _reduced_model(arch):
    cfg = tget(arch).reduced(remat=True)
    return cfg, tapi.build(cfg)


def _batch(cfg, b, s, device, labels=True):
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if labels:
        prefix = cfg.vlm_prefix if cfg.family == "vlm" else 0
        batch["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, prefix + s)))
    batch.update(tapi.stub_inputs(cfg, b, s, torch.Generator().manual_seed(4)))
    return {k: v.to(device) for k, v in batch.items()}


def _generator(device):
    return None if device == "meta" else torch.Generator().manual_seed(0)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b", "whisper-base"])
def test_train_step_peak_on_meta_equals_cpu(arch):
    cfg, model = _reduced_model(arch)
    tcfg = TrainConfig(microbatches=2)
    peaks = {}
    for device in ("cpu", "meta"):
        def window(batch):
            state = init_train_state(model, _generator(device), tcfg)
            step = make_train_step(model, tcfg)
            for _ in range(2):
                state, _ = step(state, batch)

        peaks[device] = dryrun.peak_bytes(window, _batch(cfg, 4, 32, device))
    assert peaks["meta"] == peaks["cpu"]
    assert peaks["cpu"] > 16 * sum(
        p.numel() for p in model.init(None, trainable=True).parameters())


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "xlstm-125m", "whisper-base"])
def test_generate_peak_on_meta_equals_cpu(arch):
    cfg, model = _reduced_model(arch)
    peaks = {}
    for device in ("cpu", "meta"):
        def window(batch):
            params = model.init(_generator(device))
            generate(model, params, batch, ServeConfig(max_new_tokens=4))

        peaks[device] = dryrun.peak_bytes(
            window, _batch(cfg, 2, 24, device, labels=False))
    assert peaks["meta"] == peaks["cpu"]


#: overrides that cut an arch to two narrow layers; the cell's shapes
#: (batch x seq) stay the reference's
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
            d_ff=128, vocab=256, attn_chunk=1024)


def test_run_cell_writes_the_record(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    big = dryrun.run_cell("tinyllama-1.1b", "decode_32k",
                          overrides=TINY)
    assert big["ok"] and big["fits"] and big["max_batch"] == 128
    cap = big["peak_bytes"] // 5
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k",
                          overrides=TINY, out_path=str(out),
                          tag="t", capacity_bytes=cap)
    assert json.loads(out.read_text().splitlines()[-1]) == rec
    for key in ("arch", "shape", "tag", "ok", "flops", "bytes_accessed",
                "arg_bytes", "peak_bytes", "wall_s", "mesh", "fits",
                "max_batch"):
        assert key in rec, key
    assert rec["mesh"] == "1 card" and rec["tag"] == "t" and rec["ok"]
    assert rec["flops"] == big["flops"] and not rec["fits"]
    assert rec["arg_bytes"] < rec["peak_bytes"] == big["peak_bytes"]
    # the largest power of two that fits, and twice it does not
    model = tapi.build(dataclasses.replace(tget("tinyllama-1.1b"),
                                           **TINY))
    b = rec["max_batch"]
    assert b in (1, 2, 4, 8, 16, 32, 64)
    assert dryrun.measure(model, model.cfg, "decode_32k",
                          b)["peak_bytes"] <= cap
    assert dryrun.measure(model, model.cfg, "decode_32k",
                          2 * b)["peak_bytes"] > cap


def test_run_cell_reports_a_failure():
    rec = dryrun.run_cell("no-such-arch", "train_4k")
    assert not rec["ok"] and rec["error"] and "Traceback" in rec["traceback"]


def test_cli_runs_one_cell(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["ok"] and rec["fits"] and rec["max_batch"] == 128
    assert "whisper-base x decode_32k: OK" in capsys.readouterr().out
