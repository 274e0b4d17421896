"""The port's core (keyspace, sortlib, the batched exoshuffle and the
streaming sort) against the JAX package on the same numpy inputs, every
comparison bit-identical.

The JAX distributed sorts run on an 8-device host mesh in one shared
subprocess (tests/helpers.run_with_devices); the port runs in-process on
the CPU with W = 8 as its batch axis. Outputs compare whole: every
worker segment, its pads, the valid counts and the overflow flag.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import run_with_devices
from repro.core import exoshuffle as jexo
from repro.core import keyspace as jks
from repro.core import sortlib as jsortlib
from repro_torch.core import exoshuffle as texo
from repro_torch.core import keyspace as tks
from repro_torch.core import sortlib as tsortlib
from repro_torch.core.streaming import streaming_sort
from repro_torch.kernels import u32

torch.set_num_threads(2)

W = 8
N = 1 << 12


def T(a):
    return u32.from_numpy(a, "cpu")


def N_(t):
    return u32.to_numpy(t)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _quantiles(keys, parts):
    srt = np.sort(keys)
    return [int(srt[(j * srt.size) // parts]) for j in range(1, parts)]


# ---------------------------------------------------------------------------
# keyspace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,w,explicit", [
    (8, 8, False), (32, 8, False), (12, 3, False), (1, 1, False),
    (16, 4, True), (6, 3, True)])
def test_keyspace_matches_jax(r, w, explicit):
    rng = np.random.default_rng(r * 100 + w)
    keys = rng.integers(0, 2**32, 2000, dtype=np.uint64).astype(np.uint32)
    keys[:3] = [0, 2**31, 0xFFFFFFFF]
    bounds = tuple(_quantiles(keys, r)) if explicit else None
    if explicit:  # duplicate boundaries: empty ranges must route nothing
        bounds = (bounds[0],) * 2 + bounds[2:]
    tk = tks.KeySpace(num_reducers=r, num_workers=w, boundaries=bounds)
    jk = jks.KeySpace(num_reducers=r, num_workers=w, boundaries=bounds)
    _eq(N_(tk.reducer_boundaries("cpu")), jk.reducer_boundaries())
    _eq(N_(tk.worker_boundaries("cpu")), jk.worker_boundaries())
    _eq(N_(tk.local_reducer_boundaries("cpu")), jk.local_reducer_boundaries())
    _eq(tk.worker_of_key(T(keys)).numpy(), jk.worker_of_key(jnp.asarray(keys)))
    _eq(tk.reducer_of_key(T(keys)).numpy(),
        jk.reducer_of_key(jnp.asarray(keys)))


def test_keyspace_rejects_bad_boundaries():
    with pytest.raises(ValueError, match="num_reducers-1"):
        tks.KeySpace(num_reducers=4, num_workers=2, boundaries=(1, 2))
    with pytest.raises(ValueError, match="ascending"):
        tks.KeySpace(num_reducers=4, num_workers=2, boundaries=(3, 2, 1))


@pytest.mark.parametrize("n,parts", [(1, 4), (1000, 8), (999, 1)])
def test_sampled_and_equal_boundaries_match_jax(n, parts):
    rng = np.random.default_rng(n)
    sample = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    _eq(N_(tks.sampled_boundaries(T(sample), parts)),
        jks.sampled_boundaries(jnp.asarray(sample), parts))
    _eq(N_(tks._equal_boundaries(parts, "cpu")), jks._equal_boundaries(parts))
    with pytest.raises(ValueError, match="at least one"):
        tks.sampled_boundaries(T(sample[:0]), parts)


# ---------------------------------------------------------------------------
# sortlib
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [64, 128])
def test_partition_and_gather_range_blocks_match_jax(capacity):
    rng = np.random.default_rng(capacity)
    # keys skewed into the low half: worker 0's slice overflows capacity 64
    keys = np.sort(rng.integers(0, 2**31, (W, 256), dtype=np.uint64)
                   .astype(np.uint32), axis=-1)
    vals = rng.integers(0, 2**32, (W, 256), dtype=np.uint64).astype(np.uint32)
    wb = jks.KeySpace(num_reducers=W, num_workers=W).worker_boundaries()
    starts, counts = tsortlib.partition_sorted(T(keys), T(np.asarray(wb)))
    bk, bv, ovf = tsortlib.gather_range_blocks(T(keys), T(vals), starts,
                                               counts, capacity)
    any_j = False
    for w in range(W):
        js, jc = jsortlib.partition_sorted(jnp.asarray(keys[w]), wb,
                                           impl="ref")
        _eq(starts[w].numpy(), js)
        _eq(counts[w].numpy(), jc)
        jbk, jbv, jovf = jsortlib.gather_range_blocks(
            jnp.asarray(keys[w]), jnp.asarray(vals[w]), js, jc, capacity)
        _eq(N_(bk[w]), jbk)
        _eq(N_(bv[w]), jbv)
        any_j |= bool(jovf)
    assert bool(ovf) == any_j == (capacity == 64)


# ---------------------------------------------------------------------------
# the distributed sorts, W = 8, against the JAX mesh
# ---------------------------------------------------------------------------

# name: (kind, rounds, R1, explicit boundaries, capacity_factor, key source)
CASES = {
    "s_r1_p1": ("stream", 1, 1, False, 1.5, "uniform"),
    "s_r2_p1": ("stream", 2, 1, False, 1.5, "uniform"),
    "s_r2_p2": ("stream", 2, 2, False, 1.5, "uniform"),
    "s_r1_p2_bounds": ("stream", 1, 2, True, 1.5, "zipf"),
    "s_r2_p2_bounds": ("stream", 2, 2, True, 1.5, "zipf"),
    "d_p1": ("dist", 1, 1, False, 1.5, "uniform"),
    "d_p2_bounds": ("dist", 1, 2, True, 2.0, "zipf"),
    "s_r2_overflow": ("stream", 2, 1, False, 1.5, "zipf"),
}

_JAX_SORTS = """
import json
import numpy as np
import jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.core.exoshuffle import ShuffleConfig, distributed_sort
from repro.core.streaming import streaming_sort

mesh = make_mesh((8,), ("w",))
d = np.load({inp!r})
cases = json.loads({cases!r})
out = {{}}
for name, (kind, rounds, r1, bounds) in cases.items():
    cfg = ShuffleConfig(num_workers=8, reducers_per_worker=r1,
                        capacity_factor=float(d[name + "_cf"]),
                        num_rounds=rounds, impl="ref",
                        boundaries=tuple(bounds) if bounds else None)
    k, v = jnp.asarray(d[name + "_k"]), jnp.asarray(d[name + "_v"])
    if kind == "stream":
        res = streaming_sort(k, v, mesh=mesh, axis_names="w",
                             num_rounds=rounds, cfg=cfg)
    else:
        res = distributed_sort(k, v, mesh=mesh, axis_names="w", cfg=cfg)
    for tag, a in zip(("sk", "si", "vc", "ovf"), res):
        out[name + "_" + tag] = np.asarray(a)
np.savez({outp!r}, **out)
print("OK")
"""


def _case_inputs(name):
    from repro.data.gensort import skewed_keys

    kind, rounds, r1, explicit, cf, src = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    ids = np.arange(N, dtype=np.uint32)
    keys = (skewed_keys(ids, "zipf", seed=7) if src == "zipf" else
            rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32))
    vals = rng.permutation(N).astype(np.uint32)
    bounds = _quantiles(keys, W * r1) if explicit else None
    return keys, vals, bounds, cf


@pytest.fixture(scope="module")
def jax_sorts(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_sorts")
    inp, outp = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
    arrays, cases = {}, {}
    for name, (kind, rounds, r1, _, _, _) in CASES.items():
        keys, vals, bounds, cf = _case_inputs(name)
        arrays.update({name + "_k": keys, name + "_v": vals,
                       name + "_cf": np.float64(cf)})
        cases[name] = (kind, rounds, r1, bounds)
    np.savez(inp, **arrays)
    run_with_devices(_JAX_SORTS.format(inp=inp, outp=outp,
                                       cases=json.dumps(cases)),
                     timeout=600)
    return dict(np.load(outp))


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_sorts_match_jax_mesh(name, jax_sorts):
    kind, rounds, r1, _, _, _ = CASES[name]
    keys, vals, bounds, cf = _case_inputs(name)
    cfg = texo.ShuffleConfig(num_workers=W, reducers_per_worker=r1,
                             capacity_factor=cf, num_rounds=rounds,
                             impl="kernel",
                             boundaries=tuple(bounds) if bounds else None)
    if kind == "stream":
        sk, si, vc, ovf = streaming_sort(keys, vals, num_workers=W,
                                         num_rounds=rounds, cfg=cfg,
                                         device="cpu")
    else:
        sk, si, vc, ovf = texo.distributed_sort(keys, vals, num_workers=W,
                                                cfg=cfg, device="cpu")
    _eq(N_(sk), jax_sorts[name + "_sk"], "keys")
    _eq(N_(si), jax_sorts[name + "_si"], "vals")
    _eq(vc.numpy(), jax_sorts[name + "_vc"], "valid counts")
    assert ovf == bool(jax_sorts[name + "_ovf"])
    assert ovf == (name == "s_r2_overflow")
    if not ovf:
        assert int(vc.sum()) == N


def test_streaming_sort_ref_impl_matches_kernel_impl():
    keys, vals, _, _ = _case_inputs("s_r2_p2")
    outs = [streaming_sort(keys, vals, num_workers=W, num_rounds=2,
                           impl=impl, device="cpu")
            for impl in ("kernel", "ref")]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        _eq(a.numpy(), b.numpy())


def test_reduce_partitions_matches_jax():
    keys, vals, _, _ = _case_inputs("s_r2_p2")
    cfg = texo.ShuffleConfig(num_workers=W, reducers_per_worker=4)
    jcfg = jexo.ShuffleConfig(num_workers=W, reducers_per_worker=4)
    sk, _, vc, _ = texo.distributed_sort(keys, vals, num_workers=W, cfg=cfg,
                                         device="cpu")
    seg = sk.shape[0] // W
    for w in range(W):
        run = sk[w * seg:w * seg + int(vc[w])].contiguous()
        ts, tc = texo.reduce_partitions(run, cfg, w)
        js, jc = jexo.reduce_partitions(jnp.asarray(N_(run)), jcfg,
                                        jnp.int32(w))
        _eq(ts.numpy(), js)
        _eq(tc.numpy(), jc)
    one = texo.ShuffleConfig(num_workers=W)
    s, c = texo.reduce_partitions(sk[:10], one, 0)
    assert s.tolist() == [0] and c.tolist() == [10]


def test_block_capacity_rounds_up_to_pow2():
    for n, cf in ((512, 1.5), (1000, 1.0), (8, 2.0)):
        assert (texo.ShuffleConfig(num_workers=W, capacity_factor=cf)
                .block_capacity(n)
                == jexo.ShuffleConfig(num_workers=W, capacity_factor=cf)
                .block_capacity(n))
