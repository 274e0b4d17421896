"""The port's kernels (plain torch versions, as a CPU tensor runs them)
against the JAX package's Pallas kernels in interpret mode and against
both packages' oracles — every comparison bit-identical.

Inputs are numpy arrays made from a seed and handed to both packages.
The CUDA kernels themselves run only on a card (chip_smoke.py holds
them against these same plain versions there); here a wrapper given a
non-CPU tensor must try to launch and raise, never fall back.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.lax
import jax.numpy as jnp

from repro.kernels import kway_merge as jkm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bitonic_sort import bitonic_sort_blocks as j_sort_blocks
from repro.kernels.merge_sorted import merge_sorted_pairs as j_merge_pairs
from repro.kernels.range_partition import (
    partition_offsets_blocks as j_partition_blocks)
from repro.shuffle.runtime import merge_fragments as j_merge_fragments
from repro_torch.kernels import kway_merge as tkm
from repro_torch.kernels import ops, ref, u32
from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
from repro_torch.kernels.merge_sorted import merge_sorted_pairs
from repro_torch.kernels.range_partition import (partition_offsets_blocks,
                                                 searchsorted_reference)
from repro_torch.shuffle.runtime import merge_fragments

torch.set_num_threads(2)

ADVERSARIAL = ["duplicates", "sorted", "reverse", "minmax", "pads", "high",
               "random"]


def _rng(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


def T(a):
    return u32.from_numpy(a, "cpu")


def N(t):
    return u32.to_numpy(t)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _keys(case, shape, rng):
    n = int(np.prod(shape))
    if case == "duplicates":
        k = rng.integers(0, 7, n)
    elif case == "sorted":
        k = np.sort(rng.integers(0, 2**32, n))
    elif case == "reverse":
        k = np.sort(rng.integers(0, 2**32, n))[::-1]
    elif case == "minmax":  # only the two u32 extremes
        k = np.where(rng.integers(0, 2, n) == 0, 0, 0xFFFFFFFF)
    elif case == "pads":  # every record equals the lex-max pad record
        k = np.full(n, 0xFFFFFFFF)
    elif case == "high":  # keys >= 2^31 only: an int32 compare would flip
        k = rng.integers(2**31, 2**32, n)
    else:
        k = rng.integers(0, 2**32, n)
    return np.ascontiguousarray(k.astype(np.uint32).reshape(shape))


def _vals(case, shape, rng):
    if case == "pads":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    return rng.integers(0, 3, shape).astype(np.uint32)


def _sorted_pairs(case, shape, rng):
    k, v = _keys(case, shape, rng), _vals(case, shape, rng)
    packed = np.sort(k.astype(np.uint64) << np.uint64(32) | v, axis=-1)
    return ((packed >> np.uint64(32)).astype(np.uint32),
            (packed & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _sorted_triples(case, shape, rng):
    k, v = _keys(case, shape, rng), _vals(case, shape, rng)
    i = rng.integers(0, 2**20, shape).astype(np.int32)
    sk, sv, si = jax.lax.sort((jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(i)), dimension=-1, num_keys=3)
    return np.asarray(sk), np.asarray(sv), np.asarray(si)


# ---------------------------------------------------------------------------
# u32 carriers
# ---------------------------------------------------------------------------


def test_u32_pack_orders_like_unsigned_lex():
    rng = _rng("pack")
    k = _keys("random", (4096,), rng)
    k[:4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    v = rng.integers(0, 2**32, 4096).astype(np.uint32)
    packed = u32.pack(T(k), T(v))
    want = np.argsort(k.astype(np.uint64) << np.uint64(32) | v, kind="stable")
    _eq(torch.argsort(packed, stable=True).numpy(), want)
    uk, uv = u32.unpack(packed)
    _eq(N(uk), k)
    _eq(N(uv), v)
    _eq(N(u32.narrow(u32.widen(T(k)))), k)
    assert N(u32.full((2,), 0xFFFFFFFF, "cpu")).tolist() == [0xFFFFFFFF] * 2


# ---------------------------------------------------------------------------
# the four kernels: port plain == JAX Pallas (interpret) == port ref
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_bitonic_sort_blocks_matches_pallas(case):
    rng = _rng(("sort", case))
    k, v = _keys(case, (4, 256), rng), _vals(case, (4, 256), rng)
    sk, sv = bitonic_sort_blocks(T(k), T(v))
    jk, jv = j_sort_blocks(jnp.asarray(k), jnp.asarray(v), interpret=True)
    rk, rv = ref.sort_kv_ref(T(k), T(v))
    for got, want in ((sk, jk), (sv, jv), (rk, jk), (rv, jv)):
        _eq(N(got), want, case)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_merge_sorted_pairs_matches_pallas(case):
    rng = _rng(("merge", case))
    ak, av = _sorted_pairs(case, (4, 128), rng)
    bk, bv = _sorted_pairs(case, (4, 128), rng)
    mk, mv = merge_sorted_pairs(T(ak), T(av), T(bk), T(bv))
    jk, jv = j_merge_pairs(*(jnp.asarray(a) for a in (ak, av, bk, bv)),
                           interpret=True)
    rk, rv = ref.merge_kv_ref(T(ak), T(av), T(bk), T(bv))
    for got, want in ((mk, jk), (mv, jv), (rk, jk), (rv, jv)):
        _eq(N(got), want, case)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_merge_sorted_pairs_indexed_matches_pallas(case):
    rng = _rng(("merge_idx", case))
    a = _sorted_triples(case, (4, 64), rng)
    b = _sorted_triples(case, (4, 64), rng)
    ta = (T(a[0]), T(a[1]), torch.tensor(a[2]))
    tb = (T(b[0]), T(b[1]), torch.tensor(b[2]))
    got = tkm.merge_sorted_pairs_indexed(*ta, *tb)
    want = jkm.merge_sorted_pairs_indexed(
        *(jnp.asarray(x) for x in a + b), interpret=True)
    oracle = ref.merge_kvi_ref(*ta, *tb)
    for g, o, w in zip(got, oracle, want):
        w = np.asarray(w)
        _eq(g.numpy().view(w.dtype), w, case)
        _eq(o.numpy().view(w.dtype), w, case)


_BOUNDS = {
    "duplicates": [5, 5, 5, 2**31, 2**31],
    "extremes": [0, 0xFFFFFFFF],
    "random": None,
    "none": [],
}


@pytest.mark.parametrize("bounds", list(_BOUNDS))
@pytest.mark.parametrize("case", ["sorted-rows", "one-unsorted-row"])
def test_partition_offsets_blocks_matches_pallas(bounds, case):
    rng = _rng(("partition", bounds, case))
    keys = np.sort(_keys("duplicates" if bounds == "duplicates" else "random",
                         (3, 1024), rng), axis=-1)
    if case == "one-unsorted-row":
        keys[1] = _keys("random", (1024,), rng)
    keys = np.ascontiguousarray(keys)
    b = _BOUNDS[bounds]
    b = (np.sort(rng.integers(0, 2**32, 7)).astype(np.uint32) if b is None
         else np.asarray(b, np.uint32))
    got = partition_offsets_blocks(T(keys), T(b)).numpy()
    assert got.shape == (3, b.size) and got.dtype == np.int32
    if b.size:  # the Pallas kernel needs at least one boundary
        want = np.asarray(j_partition_blocks(jnp.asarray(keys),
                                             jnp.asarray(b), interpret=True))
        _eq(got, want)
    # the searchsorted contract holds on sorted rows only; the count holds
    # on every row
    count = np.stack([(row[:, None] < b[None, :]).sum(0) for row in keys])
    _eq(got, count.reshape(3, b.size))
    if case == "sorted-rows":
        _eq(got, searchsorted_reference(keys, b))
        _eq(ref.partition_offsets_ref(T(keys), T(b)).numpy(), got)


# ---------------------------------------------------------------------------
# ops level: padding, tournaments, partition over leading dims
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 100, 1000])
def test_sort_kv_any_length_matches_pallas(n):
    rng = _rng(("sort_kv", n))
    k, v = _keys("random", (n,), rng), _keys("duplicates", (n,), rng)
    sk, sv = ops.sort_kv(T(k), T(v))
    jk, jv = jops.sort_kv(jnp.asarray(k), jnp.asarray(v), impl="pallas")
    _eq(N(sk), jk)
    _eq(N(sv), jv)
    rk, rv = ops.sort_kv(T(k), T(v), impl="ref")
    _eq(N(rk), jk)
    _eq(N(rv), jv)


@pytest.mark.parametrize("k", [2, 4, 8])
def test_kway_merge_matches_pallas(k):
    rng = _rng(("kway", k))
    rk, rv = _sorted_pairs("duplicates", (k, 64), rng)
    mk, mv = ops.kway_merge(T(rk), T(rv))
    jk, jv = jops.kway_merge(jnp.asarray(rk), jnp.asarray(rv), impl="pallas")
    _eq(N(mk), jk)
    _eq(N(mv), jv)
    mk2, mv2 = ops.kway_merge(T(rk), T(rv), impl="ref")
    _eq(N(mk2), jk)
    _eq(N(mv2), jv)


def test_partition_offsets_leading_dims_and_pad():
    rng = _rng("partition_ops")
    keys = np.sort(_keys("random", (2, 3, 512), rng), axis=-1)
    b = np.sort(rng.integers(0, 2**32, 5)).astype(np.uint32)
    got = ops.partition_offsets(T(keys), T(b)).numpy()
    want = np.asarray(jops.partition_offsets(jnp.asarray(keys),
                                             jnp.asarray(b), impl="ref"))
    _eq(got, want)
    pk, pv, n = ops.pad_to_pow2(T(keys[0, 0, :300]), T(keys[0, 0, :300]))
    assert n == 300 and pk.shape[-1] == 512
    assert (N(pk)[300:] == 0xFFFFFFFF).all() and (N(pv)[300:] == 0xFFFFFFFF).all()
    assert [ops.next_pow2(x) for x in (0, 1, 3, 1024)] == [1, 1, 4, 1024]


@pytest.mark.parametrize("case", ["duplicates", "minmax", "pads", "random"])
@pytest.mark.parametrize("k,run", [(2, 64), (8, 32)])
def test_kway_merge_indexed_matches_pallas(case, k, run):
    rng = _rng(("kwi", case, k, run))
    keys, vals, idx = _sorted_triples(case, (k, run), rng)
    want = jkm.kway_merge_indexed(jnp.asarray(keys), jnp.asarray(vals),
                                  jnp.asarray(idx), impl="pallas")
    for impl in ("kernel", "ref"):
        got = tkm.kway_merge_indexed(T(keys), T(vals), torch.tensor(idx),
                                     impl=impl)
        for g, w in zip(got, want):
            w = np.asarray(w)
            _eq(g.numpy().view(w.dtype), w, f"{case} {impl}")


def _make_frags(sizes, *, pw, key_pool=None, seed=0):
    """merge_fragments-style [(keys, ids, payload, k64), ...] windows, each
    fragment sorted by packed (key<<32|id)."""
    rng = np.random.default_rng(seed)
    frags = []
    for n in sizes:
        if key_pool is None:
            k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        else:
            k = rng.choice(np.asarray(key_pool, np.uint32), size=n)
        i = rng.integers(0, 4, n).astype(np.uint32)
        k64 = k.astype(np.uint64) << np.uint64(32) | i.astype(np.uint64)
        order = np.argsort(k64, kind="stable")
        p = rng.integers(0, 2**32, (n, pw), dtype=np.uint64).astype(np.uint32) \
            if pw else None
        frags.append((k[order], i[order], p[order] if pw else None,
                      k64[order]))
    return frags


@pytest.mark.parametrize("pw", [0, 2])
@pytest.mark.parametrize("pool", [None, [0, 1, 0xFFFFFFFF], [0xFFFFFFFF]])
def test_merge_fragments_device_matches_jax_and_numpy(pw, pool):
    frags = _make_frags([97, 1, 256, 33, 0, 128], pw=pw, key_pool=pool,
                        seed=3)
    want = j_merge_fragments(frags, pw)
    _eq(merge_fragments(frags, pw)[0], want[0])
    jax_dev = jkm.merge_fragments_device(frags, pw, impl="pallas")
    for impl in ("kernel", "ref"):
        got = tkm.merge_fragments_device(frags, pw, impl=impl, device="cpu")
        for g, w, j in zip(got, want, jax_dev):
            if w is None:
                assert g is None and j is None
            else:
                _eq(g, w, impl)
                _eq(g, j, impl)


@pytest.mark.parametrize("sizes", [[], [0, 0], [5], [0, 7, 0], [3, 3, 3]])
def test_merge_fragments_device_degenerate_windows(sizes):
    frags = _make_frags(sizes, pw=1, seed=9, key_pool=[4, 9])
    want = j_merge_fragments(frags, 1)
    got = tkm.merge_fragments_device(frags, 1, device="cpu")
    jax_dev = jkm.merge_fragments_device(frags, 1)
    for g, w, j in zip(got, want, jax_dev):
        _eq(g, w)
        _eq(g, j)


def test_merge_fragments_device_window_padding():
    frags = _make_frags([5, 0, 3], pw=1, seed=2)
    live = [f for f in frags if f[3].size]
    keys, vals, idx = tkm._pad_window(live, 8)
    jk, jv, ji = jkm._pad_window(live, 8)
    _eq(keys, jk)
    _eq(vals, jv)
    _eq(idx, ji)
    assert keys.shape == (2, 8) and (idx[1, 3:] == 8).all()


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------


def test_ref_oracles_match_jax_oracles():
    rng = _rng("oracles")
    k, v = _keys("duplicates", (3, 200), rng), _vals("duplicates", (3, 200), rng)
    i = rng.integers(0, 2**20, (3, 200)).astype(np.int32)
    for got, want in zip(ref.sort_kv_ref(T(k), T(v)),
                         jref.sort_kv_ref(jnp.asarray(k), jnp.asarray(v))):
        _eq(N(got), want)
    for got, want in zip(
            ref.sort_kvi_ref(T(k), T(v), torch.tensor(i)),
            jref.sort_kvi_ref(jnp.asarray(k), jnp.asarray(v), jnp.asarray(i))):
        w = np.asarray(w := want)
        _eq(got.numpy().view(w.dtype), w)
    b = np.sort(rng.integers(0, 8, 4)).astype(np.uint32)
    _eq(ref.histogram_ref(T(k), T(b)).numpy(),
        jref.histogram_ref(jnp.asarray(k), jnp.asarray(b)))


# ---------------------------------------------------------------------------
# no fallback: a non-CPU tensor goes to the kernel or raises
# ---------------------------------------------------------------------------


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: bitonic_sort_blocks(_meta((2, 8)), _meta((2, 8))),
    lambda: partition_offsets_blocks(_meta((2, 8)), _meta((3,))),
    lambda: merge_sorted_pairs(*[_meta((2, 8))] * 4),
    lambda: tkm.merge_sorted_pairs_indexed(*[_meta((2, 8))] * 6),
], ids=["sort", "partition", "merge", "merge_indexed"])
@pytest.mark.parametrize("capability,error", [((9, 0), "nvcc"),
                                              ((8, 0), "Hopper")])
def test_wrappers_launch_or_raise_off_cpu(call, capability, error,
                                          monkeypatch):
    from repro_torch.kernels import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: capability)
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_fns", {})
    monkeypatch.setattr(_build, "_hopper", set())
    with pytest.raises(RuntimeError, match=error):
        call()
