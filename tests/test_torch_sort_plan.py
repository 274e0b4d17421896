"""The launch plan of the port's sort kernel (csrc/bitonic_sort.cu).

The kernel runs the bitonic network as a few passes over each row; which
substages each pass runs comes from `bitonic_sort.sort_plan`, in Python,
so it is checked here on the CPU: the passes must cover every (window,
distance) substage of the network exactly once and in order, each pass
must be one the kernel can run, and replaying the passes — the fused
global passes with the kernel's own gather arithmetic — must give the
network's output bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import u32
from repro_torch.kernels.bitonic_sort import (FUSE, TILE, _compare_exchange,
                                              bitonic_network,
                                              network_substages, sort_plan)

TILES = [2, 4, 64, 512, 1 << 12, TILE]  # 512: the warp span


def expand(plan):
    """The (window, distance) substages a plan runs, in the order the
    kernel walks them: d halves, and after d = 1 the next window starts
    at d = w / 2."""
    out = []
    for w, d, n in plan:
        for _ in range(n):
            out.append((w, d))
            d >>= 1
            if d == 0:
                w <<= 1
                d = w >> 1
    return out


@pytest.mark.parametrize("lb", range(21))
@pytest.mark.parametrize("tile", TILES)
def test_sort_plan_covers_network_once_in_order(tile, lb):
    b = 1 << lb
    plan = sort_plan(b, tile)
    assert expand(plan) == network_substages(b)
    t = min(b, tile)
    assert plan[0][:2] == (2, 1)
    for i, (w, d, n) in enumerate(plan):
        if i and d >= t:  # a fused global pass
            assert 1 <= n <= FUSE and i < len(plan) - 1
            assert d >> (n - 1) >= t and 2 * d <= w <= b
        else:  # a tile pass: every distance below the tile
            assert all(dd < t for _, dd in expand([(w, d, n)]))
    windows = max(lb - (t.bit_length() - 1), 0)
    fused = sum(-(-k // FUSE) for k in range(1, windows + 1))
    assert len(plan) == 1 + fused + windows


def test_sort_plan_main_path_pass_count():
    """(8, 2^20), the map sort of every round: 1 tile sort, then for each
    of the 7 windows above the 2^13 tile one fused global pass (two for
    the last, whose 7 substages exceed FUSE = 6) and one stage merge — 16
    passes."""
    plan = sort_plan(1 << 20)
    assert len(plan) == 16
    assert sum(1 for w, d, n in plan[1:] if d >= TILE) == 8


def _global_pass(packed, w, d, n):
    """A fused global pass as bitonic_global<n> computes it: group g of a
    row holds base + k * s, s = d / 2^(n-1), base = (g / s) * 2d + g % s;
    its n substages run on the 2^n gathered records, one direction per
    group."""
    rows, b = packed.shape
    s = d >> (n - 1)
    log_s = s.bit_length() - 1
    g = torch.arange(b >> n)
    base = ((g >> log_s) << (log_s + n)) | (g & (s - 1))
    idx = base[:, None] + torch.arange(1 << n)[None, :] * s
    assert torch.equal(torch.sort(idx.flatten()).values, torch.arange(b))
    r = packed[:, idx]  # (rows, groups, 2^n): each group's "registers"
    asc = ((base & w) == 0).view(1, -1, 1)
    for m in range(n - 1, -1, -1):
        r = r.reshape(rows, b >> n, -1, 2, 1 << m)
        lo, hi = r[:, :, :, 0], r[:, :, :, 1]
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        a = asc.unsqueeze(-1)
        r = torch.stack([torch.where(a, mn, mx), torch.where(a, mx, mn)],
                        dim=3).reshape(rows, b >> n, 1 << n)
    out = torch.empty_like(packed)
    out[:, idx] = r
    return out


@pytest.mark.parametrize("b", [1, 2, 8, 256, 4096])
@pytest.mark.parametrize("tile", [2, 4, 16, 64, 512])
def test_sort_plan_replay_matches_network(tile, b):
    """With tile 2 and B = 4096 the windows take 1..11 global substages,
    so fused passes of every size 1..FUSE are replayed."""
    rng = np.random.default_rng(1000 * tile + b)
    k = rng.integers(0, 2**32, (3, b), dtype=np.uint64).astype(np.uint32)
    k[1] = rng.integers(0, 3, b)  # duplicate keys: the val decides
    k[2, : b // 2] = 0xFFFFFFFF  # lex-max pads among the records
    v = rng.integers(0, 4, (3, b)).astype(np.uint32)
    packed = u32.pack(u32.from_numpy(k, "cpu"), u32.from_numpy(v, "cpu"))
    x = packed
    plan = sort_plan(b, tile)
    t = min(b, tile)
    for i, (w, d, n) in enumerate(plan):
        if i and d >= t:
            x = _global_pass(x, w, d, n)
        else:
            for ww, dd in expand([(w, d, n)]):
                x = _compare_exchange(x, dd, ww)
    assert torch.equal(x, bitonic_network(packed))
    assert torch.equal(x, torch.sort(packed, dim=-1).values)
