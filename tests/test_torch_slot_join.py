"""The through mode's slot join (core/payload.arrival_slots and
join_by_slot) against the id join it replaced.

`distributed_sort_payload` in through mode merges (key, arrival slot)
pairs and gathers ids and payload rows by slot. The oracle here is the
composition it replaced, built from the same stages: the merge of
(key, id) pairs, then `align_payload_to_merge`. The whole output must
agree bit for bit, pad rows included, on inputs chosen for the two
places where the orders could part: equal keys across source blocks,
and the first pad of arrival order lying in a block after the first.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import exoshuffle as texo
from repro_torch.core import payload as tpay
from repro_torch.core import sortlib
from repro_torch.data import gensort
from repro_torch.kernels import u32

torch.set_num_threads(2)

PAD = 0xFFFFFFFF
N = 1 << 12
# 16 key values spread over the whole key range: every worker range
# holds 16 / W of them, so each value recurs in every source's block.
VALUES = (np.arange(16, dtype=np.uint64) * (1 << 28) + 12345).astype(
    np.uint32)

# name: (W, payload words, keys, capacity_factor)
CASES = {
    "ties_w2_pw8": (2, 8, "ties", 1.5),
    "ties_w2_pw23": (2, 23, "ties", 1.5),
    "ties_w8_pw8": (8, 8, "ties", 1.5),
    "ties_w8_pw23": (8, 23, "ties", 1.5),
    "zipf_w8_pw8_overflow": (8, 8, "zipf", 1.0),
    "first_full_w2_pw8": (2, 8, "first_full", 1.5),
    "first_full_w8_pw23": (8, 23, "first_full", 1.5),
}


def _inputs(name):
    w, pw, src, cf = CASES[name]
    ids = np.arange(N, dtype=np.uint32)
    rng = np.random.default_rng(sum(map(ord, name)))
    n = N // w
    if src == "zipf":
        keys = gensort.skewed_keys(ids, "zipf", seed=5)
    else:
        keys = VALUES[rng.integers(0, 16, N)]
    if src == "first_full":
        # source 0 sends exactly C records to worker 0 (the values of its
        # range) and the rest elsewhere: that block is full, so worker
        # 0's first pad in arrival order lies in block 1
        cap = texo.ShuffleConfig(num_workers=w,
                                 capacity_factor=cf).block_capacity(n)
        per = 16 // w
        keys[:cap] = VALUES[rng.integers(0, per, cap)]
        keys[cap:n] = VALUES[rng.integers(per, 16, n - cap)]
    payload = u32.to_numpy(gensort.gen_payload(
        u32.from_numpy(ids, "cpu"), pw))
    return keys, ids, payload, w, cf


def _id_join(keys, ids, payload, w, cf):
    """The through mode as it was: (key, id) merge, then the id join.
    Returns (mk, mv, pout, valid, overflow, rcounts)."""
    n = N // w
    cfg = texo.ShuffleConfig(num_workers=w, capacity_factor=cf)
    cap = cfg.block_capacity(n)
    k, i = u32.from_numpy(keys, "cpu"), u32.from_numpy(ids, "cpu")
    p = u32.from_numpy(payload, "cpu")
    pw = p.shape[-1]
    bv, rk, rv, rcounts, ovf = texo._exchange(
        k.reshape(w, n), i.reshape(w, n), cfg=cfg, capacity=cap)
    my = torch.arange(w, dtype=torch.int64)[:, None, None] * n
    local_row = torch.clamp((u32.widen(bv) - my) & u32.MASK, max=n - 1)
    bp = tpay.take_rows(p.reshape(w, n, pw), local_row.reshape(w, -1))
    rp = tpay.exchange_payload_blocks(bp.reshape(w, w, cap, pw))
    mk, mv = sortlib.merge_runs(rk, rv)
    pout = tpay.align_payload_to_merge(rv.reshape(w, -1),
                                       rp.reshape(w, -1, pw), mv)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    return (mk.reshape(-1), mv.reshape(-1), pout.reshape(-1, pw), valid,
            bool(ovf.any()), rcounts)


@pytest.mark.parametrize("name", list(CASES))
def test_slot_join_matches_the_id_join(name):
    keys, ids, payload, w, cf = _inputs(name)
    got = texo.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                        capacity_factor=cf, device="cpu")
    *want, rcounts = _id_join(keys, ids, payload, w, cf)
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[4] is want[4] is name.endswith("overflow")

    n, cap = N // w, u32.to_numpy(got[0]).size // (w * w)
    sk = u32.to_numpy(got[0]).reshape(w, -1).astype(np.int64)
    si = u32.to_numpy(got[1]).reshape(w, -1).astype(np.int64)
    if CASES[name][2] == "ties":
        # pairs of equal keys from two source blocks of one worker
        real = si != PAD
        cross = 0
        for d in range(w):
            _, by_key = np.unique(sk[d, real[d]], return_counts=True)
            _, by_src = np.unique(
                sk[d, real[d]] * w + si[d, real[d]] // n, return_counts=True)
            cross += (by_key ** 2).sum() - (by_src ** 2).sum()
        assert cross // 2 > 100_000
    if CASES[name][2] == "first_full":
        rc = rcounts.numpy()
        assert rc[0, 0] == cap and (rc[0, 1:] < cap).all()
        # worker 0's pads carry the row of block 1's first pad, which
        # is source 1's last row, not source 0's
        pw = payload.shape[-1]
        rows = u32.to_numpy(got[2]).reshape(w, -1, pw)[0]
        pads = si[0] == PAD
        assert pads.any()
        np.testing.assert_array_equal(
            rows[pads], np.broadcast_to(payload[2 * n - 1], rows[pads].shape))


def test_arrival_slots():
    w, cap = 4, 8
    rcounts = torch.tensor([[0, 3, 8, 11], [8, 8, 8, 8], [1, 0, 0, 7]],
                           dtype=torch.int32)
    got = u32.to_numpy(tpay.arrival_slots(rcounts, cap))
    assert got.shape == (3, w, cap)
    for d in range(3):
        for p in range(w):
            for j in range(cap):
                valid = j < min(int(rcounts[d, p]), cap)
                assert got[d, p, j] == (p * cap + j if valid else PAD)


def test_arrival_slots_refuse_more_than_2_to_the_31_slots():
    rcounts = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31 slots"):
        tpay.arrival_slots(rcounts, (1 << 30) + 1)
