"""How the port's two merge kernels split their work, replayed on the CPU.

The CUDA kernels cannot run here, so the index arithmetic that decides
which output each thread writes is replayed in numpy, step for step as
the sources compute it, and the replay's output is held bit-identical to
the JAX package's merges:

  * csrc/kway_merge.cu — rank and scatter: each record of run r lands at
    its position in r plus, for every other run s, the count of s's
    records before it (equal triples of earlier runs count, of later
    runs not), each count found by the kernel's lifting search (steps
    L/2 .. 1, then one test at the landing place);
  * csrc/merge_sorted.cu — the tiled merge path: each block's co-ranks
    by the warp-wide search (LANES splits a step), each thread's co-rank
    in the tile's staged windows by binary search, then ITEMS outputs
    merged sequentially, ties to a.
"""
import threading
import zlib

import numpy as np
import pytest

import jax.numpy as jnp

from repro.kernels import kway_merge as jkm
from repro.kernels.merge_sorted import merge_sorted_pairs as j_merge_pairs
from repro_torch.kernels import merge_sorted as tms

PAD = 0xFFFFFFFF


def _rng(tag):
    return np.random.default_rng(zlib.crc32(repr(tag).encode()))


# ---------------------------------------------------------------------------
# csrc/kway_merge.cu: rank and scatter
# ---------------------------------------------------------------------------


def kway_rank_scatter(keys, vals, idx, out_len):
    """(n, K, L) runs sorted on (key, val, idx) -> the (n, out_len) rows
    the kernel writes, and how often each output slot was written."""
    n, k, L = keys.shape
    r = np.arange(k).reshape(1, k, 1)
    o = np.broadcast_to(np.arange(L), (n, k, L)).astype(np.int64)
    for s in range(k):
        pos = np.zeros((n, k, L), np.int64)
        or_equal = s < r
        step = L
        while step > 0:
            h = step >> 1 if step > 1 else 1
            j = (pos + (h - 1 if step > 1 else 0)).reshape(n, -1)
            xk, xv, xi = (np.take_along_axis(a[:, s, :], j, axis=1)
                          .reshape(n, k, L) for a in (keys, vals, idx))
            p = (xk < keys) | ((xk == keys) & (
                (xv < vals) | ((xv == vals) & np.where(or_equal, xi <= idx,
                                                       xi < idx))))
            pos += np.where(p & (r != s), h, 0)
            step >>= 1
        o += pos
    out = [np.zeros((n, out_len), a.dtype) for a in (keys, vals, idx)]
    writes = np.zeros((n, out_len), np.int64)
    rows = np.broadcast_to(np.arange(n).reshape(n, 1, 1), o.shape)
    keep = o < out_len
    for dst, a in zip(out, (keys, vals, idx)):
        dst[rows[keep], o[keep]] = a[keep]
    np.add.at(writes, (rows[keep], o[keep]), 1)
    return out, writes


def _window(case, k, L, rng):
    """A (K, L) window as merge_fragments_device pads it: fragments of
    up to L records with ordinals base.., lex-max pads with ordinal =
    total; each run sorted on (key, val, idx)."""
    if case == "pad-runs":  # fewer fragments than K: whole runs of pads
        sizes = [L] * max(1, k // 2 + 1 if k > 2 else 1) + [0] * k
    elif case == "ragged":
        sizes = rng.integers(0, L + 1, k).tolist()
        sizes[0] = max(sizes[0], 1)
    else:
        sizes = [L] * k
    sizes = sizes[:k]
    total = sum(sizes)
    keys = np.full((k, L), PAD, np.uint32)
    vals = np.full((k, L), PAD, np.uint32)
    idx = np.full((k, L), total, np.int32)
    base = 0
    for run, m in enumerate(sizes):
        if case == "duplicates":
            kk, vv = rng.integers(0, 3, m), rng.integers(0, 2, m)
        elif case == "all-equal":
            kk, vv = np.full(m, 7), np.full(m, 7)
        elif case == "pad-equal":  # real records equal to the pad key/val
            kk = np.where(rng.integers(0, 2, m) == 0, PAD, 5)
            vv = np.full(m, PAD)
        else:
            kk = rng.integers(0, 2**32, m, dtype=np.uint64)
            vv = rng.integers(0, 2**32, m, dtype=np.uint64)
        kk, vv = kk.astype(np.uint32), vv.astype(np.uint32)
        order = np.lexsort((vv, kk))  # stable: ordinals stay ascending
        keys[run, :m], vals[run, :m] = kk[order], vv[order]
        idx[run, :m] = np.arange(base, base + m)
        base += m
    return keys, vals, idx, total


@pytest.mark.parametrize("case", ["random", "duplicates", "all-equal",
                                  "pad-equal", "pad-runs", "ragged"])
@pytest.mark.parametrize("L", [1, 2, 8, 64, 512, 4096])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_kway_rank_rule_matches_jax(k, L, case):
    keys, vals, idx, total = _window(case, k, L, _rng(("kway", k, L, case)))
    want = [np.asarray(w) for w in jkm.kway_merge_indexed(
        jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(idx),
        impl="network")]
    # the whole window: every slot written once, the network's output
    (mk, mv, mi), writes = kway_rank_scatter(keys[None], vals[None],
                                             idx[None], k * L)
    assert (writes == 1).all()
    for got, w in zip((mk[0], mv[0], mi[0]), want):
        np.testing.assert_array_equal(got, w)
    # the window path keeps the first `total` records: the real ones
    (mk, mv, mi), writes = kway_rank_scatter(keys[None], vals[None],
                                             idx[None], total)
    assert (writes == 1).all()
    assert (mi[0] < total).all()
    for got, w in zip((mk[0], mv[0], mi[0]), want):
        np.testing.assert_array_equal(got, w[:total])


@pytest.mark.parametrize("case", ["random", "duplicates", "all-equal"])
def test_kway_rank_rule_pairs_over_rows_matches_pallas(case):
    """K = 2 over n rows: merge_sorted_pairs_indexed's launch."""
    rng = _rng(("pairs", case))
    rows = [_window(case, 2, 32, rng)[:3] for _ in range(3)]
    keys, vals, idx = (np.stack([r[i] for r in rows]) for i in range(3))
    (mk, mv, mi), writes = kway_rank_scatter(keys, vals, idx, 64)
    assert (writes == 1).all()
    want = jkm.merge_sorted_pairs_indexed(
        jnp.asarray(keys[:, 0]), jnp.asarray(vals[:, 0]),
        jnp.asarray(idx[:, 0]), jnp.asarray(keys[:, 1]),
        jnp.asarray(vals[:, 1]), jnp.asarray(idx[:, 1]), interpret=True)
    for got, w in zip((mk, mv, mi), want):
        np.testing.assert_array_equal(got, np.asarray(w))


# ---------------------------------------------------------------------------
# csrc/merge_sorted.cu: the tiled merge path
# ---------------------------------------------------------------------------


def corank_warp(a, b, d, lanes):
    """The block co-rank of diagonal d (corank() in the source): how many
    of the first d outputs come from a, ties to a. a, b: packed u64."""
    L = a.size
    lo, hi = max(d - L, 0), min(d, L)
    while lo < hi:
        n = hi - lo
        q = lo + (np.arange(1, lanes + 1) * n) // lanes - 1
        p = np.zeros(lanes, bool)
        ok = q >= lo
        p[ok] = a[q[ok]] > b[d - 1 - q[ok]]
        if not p.any():
            return hi
        f = int(np.argmax(p))
        hi = lo + (f + 1) * n // lanes - 1
        lo += f * n // lanes
    return lo


def merge_tiles(a, b, *, threads, items, lanes):
    """One row's merge as merge_tiles<> computes it; returns the output
    and each tile's (i0, i1) co-ranks."""
    L = a.size
    tile = min(2 * L, threads * items)
    out = np.zeros(2 * L, np.uint64)
    coranks = []
    for d0 in range(0, 2 * L, tile):
        i0, i1 = (corank_warp(a, b, d, lanes) for d in (d0, d0 + tile))
        coranks.append((i0, i1))
        na, j0 = i1 - i0, d0 - i0
        nb = tile - na
        # the staged windows, and a 0 at [tile] for a side that ran out
        s = np.concatenate([a[i0:i1], b[j0:j0 + nb], np.zeros(1, np.uint64)])
        dd = np.minimum(np.arange(threads) * items, tile)
        lo, hi = np.maximum(0, dd - nb), np.minimum(dd, na)
        while (lo < hi).any():
            act = lo < hi
            mid = (lo + hi) >> 1
            gt = np.zeros(threads, bool)
            gt[act] = s[mid[act]] > s[na + dd[act] - 1 - mid[act]]
            hi = np.where(act & gt, mid, hi)
            lo = np.where(act & ~gt, mid + 1, lo)
        i, j = lo.copy(), dd - lo
        for m in range(items):
            live = dd + m < tile
            x = s[np.where(i < na, i, tile)]
            y = s[np.where(j < nb, na + j, tile)]
            take_a = (j >= nb) | ((i < na) & (x <= y))
            got = np.where(take_a, x, y)
            out[d0 + dd[live] + m] = got[live]
            i = np.where(take_a, i + 1, i)
            j = np.where(take_a, j, j + 1)
    return out, coranks


def _pack(k, v):
    return k.astype(np.uint64) << np.uint64(32) | v.astype(np.uint64)


def _run(case, L, rng, side):
    if case == "duplicates":
        k, v = rng.integers(0, 3, L), rng.integers(0, 2, L)
    elif case == "all-equal":
        k = v = np.full(L, 9)
    elif case == "pad-tail":  # real records, then lex-max pads (~2x)
        k = np.where(np.arange(L) < L // 2 + side,
                     rng.integers(0, 2**32, L, dtype=np.uint64), PAD)
        v = np.where(np.arange(L) < L // 2 + side,
                     rng.integers(0, 4, L), PAD)
    elif case == "disjoint":  # a below b: each tile exhausts one side
        k = rng.integers(0, 2**31, L, dtype=np.uint64) + side * 2**31
        v = rng.integers(0, 4, L)
    elif case == "nested":  # a inside one stretch of b
        k = (rng.integers(2**30, 2**30 + 2**20, L, dtype=np.uint64) if side
             == 0 else rng.integers(0, 2**32, L, dtype=np.uint64))
        v = rng.integers(0, 4, L)
    else:
        k = rng.integers(0, 2**32, L, dtype=np.uint64)
        v = rng.integers(0, 2**32, L, dtype=np.uint64)
    return np.sort(_pack(k.astype(np.uint32), v.astype(np.uint32)))


GEOMETRIES = {  # (threads, items, lanes): the kernel's, and a small one
    "kernel": (tms.THREADS, tms.ITEMS, tms.LANES),
    "small": (8, 4, 4),
}


@pytest.mark.parametrize("case", ["random", "duplicates", "all-equal",
                                  "pad-tail", "disjoint", "nested"])
@pytest.mark.parametrize("geometry,L", [
    ("kernel", 1), ("kernel", 2), ("kernel", 512), ("kernel", 1024),
    ("kernel", 2048), ("kernel", 4096), ("small", 16),
    ("small", 128)])
def test_tiled_merge_path_matches_pallas(geometry, L, case):
    """Lengths below one tile (2L < TILE), at it and above; each tile's
    co-ranks equal the merge's, and the output the JAX kernel's."""
    threads, items, lanes = GEOMETRIES[geometry]
    rng = _rng(("tiles", geometry, L, case))
    a, b = _run(case, L, rng, 0), _run(case, L, rng, 1)
    got, coranks = merge_tiles(a, b, threads=threads, items=items,
                               lanes=lanes)
    # co-ranks: how many of a fall in the first d outputs, ties to a
    tile = min(2 * L, threads * items)
    for t, (i0, i1) in enumerate(coranks):
        for d, c in ((t * tile, i0), ((t + 1) * tile, i1)):
            want = max(i for i in range(max(0, d - L), min(d, L) + 1)
                       if i == 0 or d - i == L or a[i - 1] <= b[d - i])
            assert c == want, (t, d)
    split = lambda x: ((x >> np.uint64(32)).astype(np.uint32),  # noqa: E731
                       (x & np.uint64(PAD)).astype(np.uint32))
    (ak, av), (bk, bv) = split(a), split(b)
    jk, jv = j_merge_pairs(*(jnp.asarray(x[None]) for x in (ak, av, bk, bv)),
                           interpret=True)
    gk, gv = split(got)
    np.testing.assert_array_equal(gk, np.asarray(jk)[0])
    np.testing.assert_array_equal(gv, np.asarray(jv)[0])


# ---------------------------------------------------------------------------
# merge_fragments_device: the staged window and its counters
# ---------------------------------------------------------------------------


def _frags(sizes, rng, pw=2):
    out = []
    for n in sizes:
        k = rng.choice(np.array([0, 3, PAD], np.uint32), n)
        i = rng.integers(0, 4, n).astype(np.uint32)
        k64 = k.astype(np.uint64) << np.uint64(32) | i
        o = np.argsort(k64, kind="stable")
        p = rng.integers(0, 2**32, (n, pw), dtype=np.uint64).astype(np.uint32)
        out.append((k[o], i[o], p[o], k64[o]))
    return out


@pytest.mark.parametrize("sizes", [[5, 3], [1, 7, 2], [4, 4, 4, 4, 1]])
def test_pad_window_fills_a_staging_buffer_in_place(sizes):
    """The card's path packs the window into its pinned (3, K, L) buffer;
    the packing equals the JAX package's _pad_window."""
    from repro_torch.kernels import kway_merge as tkm

    frags = _frags(sizes, _rng(("stage", tuple(sizes))))
    total = sum(sizes)
    want = jkm._pad_window(frags, total)
    buf = np.full((3,) + want[0].shape, 123, np.int32)
    got = tkm._pad_window(frags, total, out=buf)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(buf[0].view(np.uint32), want[0])
    np.testing.assert_array_equal(buf[2], want[2])


def test_merge_fragments_device_counts_windows_and_splits_steps():
    from repro_torch.kernels import kway_merge as tkm

    rng = _rng("counters")
    f = tkm.merge_fragments_device
    f.windows = f.records = 0
    f(_frags([3, 4], rng), 2, device="cpu")
    f(_frags([6], rng), 2, device="cpu")  # one fragment: no merge
    split = {}
    f(_frags([2, 0, 5], rng), 2, device="cpu", split=split)
    assert (f.windows, f.records) == (2, 14)
    assert set(split) == {"pad", "kernel", "gather"}
    assert all(us >= 0 for us in split.values())


def test_pinned_staging_buffers_grow_and_slice_exactly(monkeypatch):
    """The per-thread staging buffers: each window gets views of exactly
    the sizes it asked for; they grow (by powers of two) only when a
    window outgrows them and are reused otherwise. The CPU build has no
    page-locked memory, so the allocation drops `pin_memory` here."""
    import torch

    from repro_torch.kernels import kway_merge as tkm

    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    monkeypatch.setattr(tkm, "_staging", threading.local())
    dev = torch.device("cuda")
    a_in, a_out = tkm._pinned(dev, 10, 4)
    assert (a_in.numel(), a_out.numel()) == (10, 4)
    b_in, b_out = tkm._pinned(dev, 100, 3)
    assert (b_in.numel(), b_out.numel()) == (100, 3)
    assert b_in.untyped_storage().nbytes() == 4 * 128
    c_in, c_out = tkm._pinned(dev, 5, 4)
    assert (c_in.numel(), c_out.numel()) == (5, 4)
    assert c_in.data_ptr() == b_in.data_ptr()
    assert c_out.data_ptr() == b_out.data_ptr()
