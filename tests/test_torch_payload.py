"""The port's payload modes (core/payload.py and
core/exoshuffle.distributed_sort_payload) against the JAX package on the
same numpy inputs.

The JAX functions run once, jit-compiled under shard_map on host meshes
of 2 and 8 devices, in one module-scoped subprocess
(tests/helpers.run_with_devices); the port runs in-process on the CPU
with the W workers as its batch axis. What must agree:

  * "through" mode: the whole output — keys, ids, every payload row
    (pads included: their rows are deterministic), valid counts and the
    overflow flag;
  * "late" mode: keys, ids, counts, the overflow flag, and each worker's
    valid prefix of payload rows (the reference leaves pad rows
    unspecified);
  * late_fetch_payload alone: every row whose request fit its block,
    pads included, and the overflow flag, also at a capacity that
    overflows.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.core import exoshuffle as jexo
from repro.data import gensort as jgensort
from repro_torch.core import exoshuffle as texo
from repro_torch.core import payload as tpay
from repro_torch.data import gensort, valsort
from repro_torch.kernels import u32

torch.set_num_threads(2)

PAD = 0xFFFFFFFF
N = 1 << 12

# name: (W, payload words, mode, key source, capacity_factor)
SORTS = {
    "w2_pw8_through": (2, 8, "through", "uniform", 1.5),
    "w2_pw8_late": (2, 8, "late", "uniform", 1.5),
    "w2_pw23_through": (2, 23, "through", "uniform", 1.5),
    "w2_pw23_late": (2, 23, "late", "uniform", 1.5),
    "w8_pw8_through": (8, 8, "through", "uniform", 1.5),
    "w8_pw8_late": (8, 8, "late", "uniform", 1.5),
    "w8_pw23_through": (8, 23, "through", "uniform", 1.5),
    "w8_pw23_late": (8, 23, "late", "uniform", 1.5),
    "w8_pw8_through_overflow": (8, 8, "through", "zipf", 1.0),
    "w8_pw8_late_overflow": (8, 8, "late", "zipf", 1.0),
}

# late_fetch_payload / align_payload_to_merge alone: W = 8 workers of
# n = 64 produced rows, m = 80 requested ids (64 real, 16 pads) each.
FW, FN, FM, FPW = 8, 64, 80, 5
FETCH_CAPS = {"fits": 32, "overflows": 4}

_JAX = """
import json
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import compat
from repro.core import payload as pay
from repro.core.exoshuffle import ShuffleConfig, distributed_sort_payload

d = np.load({inp!r})
sorts = json.loads({sorts!r})
out = {{}}
for name, (w, pw, mode, src, cf) in sorts.items():
    mesh = Mesh(np.array(jax.devices()[:w]), ("w",))
    cfg = ShuffleConfig(num_workers=w, reducers_per_worker=2,
                        capacity_factor=cf, impl="ref")
    fn = jax.jit(lambda k, i, p: distributed_sort_payload(
        k, i, p, mesh=mesh, axis_names="w", mode=mode, cfg=cfg))
    res = fn(d[name + "_k"], d[name + "_i"], d[name + "_p"])
    for tag, a in zip(("sk", "si", "sp", "vc", "ovf"), res):
        out[name + "_" + tag] = np.asarray(a)

mesh = Mesh(np.array(jax.devices()[:{fw}]), ("w",))
spec, rows = P("w"), P("w", None)
align = jax.jit(compat.shard_map(
    pay.align_payload_to_merge, mesh=mesh, in_specs=(spec, rows, spec),
    out_specs=rows, check_vma=False))
out["align"] = np.asarray(align(d["align_recv"], d["align_payload"],
                                d["align_merged"]))
for tag, cap in json.loads({caps!r}).items():
    def fetch(ids, local, cap=cap):
        rows_, ovf = pay.late_fetch_payload(
            ids, local, axis="w", num_workers={fw},
            records_per_worker={fn_}, capacity=cap)
        return rows_, ovf[None]
    f = jax.jit(compat.shard_map(fetch, mesh=mesh, in_specs=(spec, rows),
                                 out_specs=(rows, spec), check_vma=False))
    got, ovf = f(d["fetch_ids"], d["fetch_local"])
    out["fetch_" + tag] = np.asarray(got)
    out["fetch_" + tag + "_ovf"] = np.asarray(ovf)
np.savez({outp!r}, **out)
print("OK")
"""


def _sort_inputs(name):
    w, pw, mode, src, cf = SORTS[name]
    ids = np.arange(N, dtype=np.uint32)
    if src == "zipf":
        keys = jgensort.skewed_keys(ids, "zipf", seed=5)
    else:
        keys = np.asarray(jgensort.splitmix32(ids))
    payload = np.asarray(jgensort.gen_payload(ids, pw))
    return keys, ids, payload


def _fetch_inputs():
    rng = np.random.default_rng(11)
    ids = rng.permutation(FW * FN).astype(np.uint32).reshape(FW, FN)
    req = np.concatenate([ids, np.full((FW, FM - FN), PAD, np.uint32)], 1)
    req = np.stack([rng.permutation(r) for r in req])
    local = rng.integers(0, 2**32, (FW * FN, FPW),
                         dtype=np.uint64).astype(np.uint32)
    return req, local


def _align_inputs():
    rng = np.random.default_rng(12)
    recv = rng.permutation(1 << 20)[:FW * FM].astype(np.uint32)
    recv = recv.reshape(FW, FM)
    recv[:, -7:] = PAD  # pads arrive at each worker's tail
    merged = np.stack([rng.permutation(r) for r in recv])
    payload = rng.integers(0, 2**32, (FW * FM, FPW),
                           dtype=np.uint64).astype(np.uint32)
    return recv, payload, merged


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_payload")
    inp, outp = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
    arrays = {}
    for name in SORTS:
        arrays.update(zip((name + "_k", name + "_i", name + "_p"),
                          _sort_inputs(name)))
    req, local = _fetch_inputs()
    recv, payload, merged = _align_inputs()
    arrays.update(fetch_ids=req.reshape(-1), fetch_local=local,
                  align_recv=recv.reshape(-1), align_payload=payload,
                  align_merged=merged.reshape(-1))
    np.savez(inp, **arrays)
    run_with_devices(_JAX.format(inp=inp, outp=outp, sorts=json.dumps(SORTS),
                                 caps=json.dumps(FETCH_CAPS), fw=FW, fn_=FN),
                     timeout=600)
    return dict(np.load(outp))


def T(a):
    return u32.from_numpy(a, "cpu")


def N_(t):
    return u32.to_numpy(t)


# ---------------------------------------------------------------------------
# the module's functions alone
# ---------------------------------------------------------------------------


def test_align_payload_to_merge_matches_jax(jax_out):
    recv, payload, merged = _align_inputs()
    got = tpay.align_payload_to_merge(T(recv), T(payload).reshape(FW, FM, -1),
                                      T(merged))
    np.testing.assert_array_equal(N_(got).reshape(-1, FPW), jax_out["align"])


def _fetched_positions(req, cap):
    """(W, m) masks over each worker's requests: `fit`, the requests that
    fit their producer block (the rows the reference defines, pads
    included), and `clobbered`, the one request whose row the
    reference's scatter overwrites. The reference scatters every block
    row j < C to sorted position clip(starts[p] + j, 0, m-1), so the
    unused rows of the block that owns the last sorted position land on
    that position after its valid row: its row is garbage unless that
    block is the last one and full."""
    fit = np.zeros(req.shape, bool)
    clobbered = np.zeros(req.shape, bool)
    for w in range(FW):
        pos = np.arange(FM)
        prod = np.minimum(req[w].astype(np.int64) // FN, FW - 1)
        prod = np.where(req[w] == PAD, pos % FW, prod)
        order = np.argsort(prod, kind="stable")
        starts = np.searchsorted(prod[order], np.arange(FW))
        counts = np.diff(np.append(starts, FM))
        j = np.empty(FM, np.int64)
        j[order] = np.arange(FM) - starts[prod[order]]
        fit[w] = j < cap
        if not (prod[order[-1]] == FW - 1 and counts[-1] >= cap):
            clobbered[w, order[-1]] = True
    return fit, clobbered


@pytest.mark.parametrize("tag", list(FETCH_CAPS))
def test_late_fetch_payload_matches_jax(tag, jax_out):
    req, local = _fetch_inputs()
    cap = FETCH_CAPS[tag]
    got, ovf = tpay.late_fetch_payload(
        T(req), T(local).reshape(FW, FN, FPW), num_workers=FW,
        records_per_worker=FN, capacity=cap)
    got, want = N_(got), jax_out["fetch_" + tag].reshape(FW, FM, FPW)
    assert bool(ovf) == bool(jax_out["fetch_" + tag + "_ovf"].any())
    assert bool(ovf) == (tag == "overflows")
    fit, clobbered = _fetched_positions(req, cap)
    assert fit.all() == (tag == "fits")
    same = fit & ~clobbered
    np.testing.assert_array_equal(got[same], want[same])
    # every real id that fits carries its producer's row — also the one
    # the reference's scatter clobbers (a real id in this input)
    real = fit & (req != PAD)
    np.testing.assert_array_equal(got[real],
                                  local[req[real].astype(np.int64)])
    if tag == "fits":
        hit = real & clobbered
        assert hit.any() and not np.array_equal(got[hit], want[hit])


# ---------------------------------------------------------------------------
# distributed_sort_payload, both modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SORTS))
def test_distributed_sort_payload_matches_jax(name, jax_out):
    w, pw, mode, src, cf = SORTS[name]
    keys, ids, payload = _sort_inputs(name)
    cfg = texo.ShuffleConfig(num_workers=w, reducers_per_worker=2,
                             capacity_factor=cf)
    sk, si, sp, vc, ovf = texo.distributed_sort_payload(
        keys, ids, payload, num_workers=w, mode=mode, cfg=cfg, device="cpu")
    want = {t: jax_out[f"{name}_{t}"] for t in ("sk", "si", "sp", "vc", "ovf")}
    np.testing.assert_array_equal(N_(sk), want["sk"])
    np.testing.assert_array_equal(N_(si), want["si"])
    np.testing.assert_array_equal(vc.numpy(), want["vc"])
    assert ovf == bool(want["ovf"]) == name.endswith("overflow")
    got_p = N_(sp)
    assert got_p.shape == want["sp"].shape
    if mode == "through":
        np.testing.assert_array_equal(got_p, want["sp"])
    elif not ovf:
        seg = got_p.shape[0] // w
        for d in range(w):
            lo = d * seg
            hi = lo + int(vc[d])
            np.testing.assert_array_equal(got_p[lo:hi], want["sp"][lo:hi])
    if not ovf:
        ks, iss, ps = valsort.slice_segments(sk, si, vc, sp)
        in_ck = gensort.checksum(T(keys), T(ids), T(payload))
        jax_ck = jgensort.checksum(keys, ids, payload)
        assert in_ck == (int(jax_ck[0]), int(jax_ck[1]))
        rep = valsort.validate(ks, iss, in_ck, ps, device="cpu")
        assert rep.ok and rep.total_records == N, rep


def test_distributed_sort_payload_rejects_bad_mode_and_missing_cuda():
    keys, ids, payload = _sort_inputs("w2_pw8_through")
    with pytest.raises(ValueError, match="payload mode"):
        texo.distributed_sort_payload(keys, ids, payload, num_workers=2,
                                      mode="early", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            texo.distributed_sort_payload(keys, ids, payload, num_workers=2)


def test_config_from_reference_maps_impl():
    for jimpl, timpl in (("pallas", "kernel"), ("ref", "ref")):
        ref = jexo.ShuffleConfig(num_workers=8, reducers_per_worker=4,
                                 capacity_factor=2.0, num_rounds=2,
                                 impl=jimpl, boundaries=tuple(range(1, 32)))
        cfg = texo.config_from_reference(dataclasses.asdict(ref))
        assert cfg.impl == timpl
        assert cfg.boundaries == ref.boundaries
        assert cfg.block_capacity(1000) == ref.block_capacity(1000)
        assert (N_(cfg.keyspace.worker_boundaries("cpu")).tolist()
                == np.asarray(ref.keyspace.worker_boundaries()).tolist())


# ---------------------------------------------------------------------------
# the e2e example's twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["through", "late"])
def test_e2e_example_runs_on_cpu(mode, capsys):
    from repro_torch.examples import cloudsort_e2e

    out = cloudsort_e2e.main(["--records", str(1 << 14), "--device", "cpu",
                              "--payload-mode", mode])
    assert out["valsort_ok"] and out["records"] == 1 << 14
    keys, ids = jgensort.gen_keys(0, 1 << 14)
    jck = jgensort.checksum(keys, ids, jgensort.gen_payload(ids, 8))
    assert out["checksum"] == (int(jck[0]), int(jck[1]))
    text = capsys.readouterr().out
    assert "[valsort] within=True across=True checksum=True" in text
    assert "[cost] paper 100TB TCO" in text and "TPU" not in text
