"""The through mode's payload rows (core/payload.send_rows,
arrival_slots and gather_by_slot) against one oracle: the id join.

`distributed_sort_payload` in through mode merges (key, arrival slot)
pairs and gathers the ids and payload rows by slot after the merge:
without a mesh straight from their producers' input, on a rank mesh from
the blocks packed and exchanged beside their headers. The oracle is the
reference's design, built from public stages after the shared front end
(`exoshuffle._exchange`): each sent block's rows packed by
`payload.local_rows` and exchanged, the merge of (key, id) pairs
(`sortlib.merge_runs`), the id join (`payload.align_payload_to_merge`)
and, for a 10-byte key, the key-tail stage (`keytail.order_key_tails`).
The whole output must agree bit for bit, pad rows included, without a
mesh and over one gloo rank holding all W workers, on inputs chosen for
the places where the paths could part: equal keys across source blocks,
an overflowing zipf input, the first pad of arrival order in a block
after the first, ids outside the id // n layout, and key_bytes=10.
Without a mesh the aten ops inside `payload.join` are pinned, op for op.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import exoshuffle as texo
from repro_torch.core import keytail, sortlib
from repro_torch.core import payload as tpay
from repro_torch.data import gensort
from repro_torch.kernels import _build, u32
from repro_torch.kernels.slot_gather import (gather_slot_rows,
                                             gather_slot_rows_plain)
from repro_torch.launch import mesh as tmesh
from repro_torch.obs import device
from repro_torch.obs.metrics import MetricsRegistry

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
    # every block holds exactly C records: no pad slot at all
    "all_full_w8_pw23": (8, 23, "all_full", 1.0),
    # every key in worker 0's range: worker 1's blocks are all empty
    "all_empty_w2_pw8": (2, 8, "all_empty", 2.0),
    # real keys 0xFFFFFFFF, the pad's key, merged beside the pads
    "pad_keys_w8_pw1": (8, 1, "pad_keys", 1.5),
}


def _inputs(name):
    w, pw, src, cf = CASES[name]
    ids = np.arange(N, dtype=np.uint32)
    rng = np.random.default_rng(sum(map(ord, name)))
    n = N // w
    per = 16 // w  # key values in each worker's range
    if src == "zipf":
        keys = gensort.skewed_keys(ids, "zipf", seed=5)
    elif src == "all_full":
        # each source sends n / W records to every worker
        keys = VALUES[np.arange(N) % n // (n // w) * per
                      + rng.integers(0, per, N)]
    elif src == "all_empty":
        keys = VALUES[rng.integers(0, per, N)]
    else:
        keys = VALUES[rng.integers(0, 16, N)]
    if src == "pad_keys":
        keys[rng.random(N) < 0.05] = PAD
    if src == "first_full":
        # source 0 sends exactly C records to worker 0 (the values of its
        # range) and the rest elsewhere: that block is full, so worker
        # 0's first pad in arrival order lies in block 1
        cap = texo.ShuffleConfig(num_workers=w,
                                 capacity_factor=cf).block_capacity(n)
        keys[:cap] = VALUES[rng.integers(0, per, cap)]
        keys[cap:n] = VALUES[rng.integers(per, 16, n - cap)]
    payload = u32.to_numpy(gensort.gen_payload(
        u32.from_numpy(ids, "cpu"), pw))
    return keys, ids, payload, w, cf


def _foreign_ids(name):
    """A case's input with ids outside the id // n layout: producer p's
    ids are distinct and sorted in [p*S, (p+1)*S - 1), S = 2^32 / W, so
    nearly all lie above the producer's rows and half of them at or
    above 2^31. Every id of producer p still lies below every id of
    producer p + 1, the one property of the layout the slot merge
    needs to order as the (key, id) merge does."""
    keys, _, payload, w, cf = _inputs(name)
    rng = np.random.default_rng(11)
    n, s = N // w, (1 << 32) // w
    ids = np.concatenate([
        np.sort(rng.integers(0, s - n, n)) + np.arange(n) + p * s
        for p in range(w)]).astype(np.uint32)
    return keys, ids, payload, w, cf


# name: (the input, key bytes)
INPUTS = {name: (_inputs, 4) for name in CASES}
INPUTS.update({
    "foreign_ids_ties_w8_pw23": (_foreign_ids, 4),
    "foreign_ids_zipf_w8_pw8_overflow": (_foreign_ids, 4),
    "foreign_ids_first_full_w2_pw8": (_foreign_ids, 4),
    "key10_ties_w8_pw8": (_inputs, 10),
    "key10_ties_w2_pw23": (_inputs, 10),
    "key10_first_full_w8_pw23": (_inputs, 10),
    "key10_zipf_w8_pw8_overflow": (_inputs, 10),
})


def _case(name):
    make, key_bytes = INPUTS[name]
    base = name.removeprefix("foreign_ids_").removeprefix("key10_")
    return (*make(base), key_bytes)


def _id_join(keys, ids, payload, w, cf, key_bytes):
    """The oracle: (mk, mv, pout, valid, overflow) as
    distributed_sort_payload returns them, and the received counts."""
    n = len(keys) // w
    cfg = texo.ShuffleConfig(num_workers=w, capacity_factor=cf)
    cap = cfg.block_capacity(n)
    k, i = u32.from_numpy(keys, "cpu"), u32.from_numpy(ids, "cpu")
    p = u32.from_numpy(payload, "cpu")
    pw = p.shape[-1]
    bv, rk, rv, rcounts, ovf = texo._exchange(
        k.reshape(w, n), i.reshape(w, n), cfg=cfg, capacity=cap)
    first = torch.arange(w, dtype=torch.int64)[:, None, None] * n
    bp = tpay.take_rows(p.reshape(w, n, pw),
                        tpay.local_rows(bv, first, n).reshape(w, -1))
    rp = tpay.exchange_payload_blocks(bp.reshape(w, w, cap, pw))
    mk, mv = sortlib.merge_runs(rk, rv)
    pout = tpay.align_payload_to_merge(rv.reshape(w, -1),
                                       rp.reshape(w, -1, pw), mv)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    if key_bytes == 10:
        _, tail_ovf = keytail.order_key_tails(
            mk, mv, pout, valid,
            keytail.pair_capacity(n, w, w, mk.shape[-1], cf))
        ovf = ovf | tail_ovf
    return (mk.reshape(-1), mv.reshape(-1), pout.reshape(-1, pw), valid,
            bool(ovf.any())), rcounts


def _assert_same(got, want):
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[4] is want[4]


def _world_of_one(w, tmp_path):
    return tmesh.init_rank_mesh(w, backend="gloo", device="cpu", rank=0,
                                world=1, store_path=str(tmp_path / "s"))


@pytest.mark.parametrize("where", ["no_mesh", "rank_mesh"])
@pytest.mark.parametrize("name", list(INPUTS))
def test_through_rows_match_the_id_join(name, where, tmp_path):
    keys, ids, payload, w, cf, key_bytes = _case(name)
    kw = dict(num_workers=w, capacity_factor=cf, key_bytes=key_bytes)
    if where == "no_mesh":
        got = texo.distributed_sort_payload(keys, ids, payload,
                                            device="cpu", **kw)
    else:
        mesh = _world_of_one(w, tmp_path)
        try:
            got = texo.distributed_sort_payload(keys, ids, payload,
                                                mesh=mesh, **kw)
        finally:
            mesh.close()
    want, rcounts = _id_join(keys, ids, payload, w, cf, key_bytes)
    _assert_same(got, want)
    assert got[4] is name.endswith("overflow")

    n, cap = N // w, got[1].numel() // (w * w)
    sk = u32.to_numpy(got[0]).reshape(w, -1).astype(np.int64)
    si = u32.to_numpy(got[1]).reshape(w, -1).astype(np.int64)
    pads = si == PAD
    assert pads.any() != name.endswith("all_full_w8_pw23")
    if name.startswith("foreign_ids"):
        # most records' ids lie outside their producer's rows
        producer = np.arange(ids.size) // n
        assert (ids // n != producer).mean() > 0.5
    if name.startswith("key10"):
        # the key-tail stage had runs of equal key words to order
        assert (sk[:, 1:] == sk[:, :-1])[~pads[:, 1:]].sum() > 100
    if name not in CASES:
        return
    if CASES[name][2] == "ties":
        # pairs of equal keys from two source blocks of one worker
        cross = 0
        for d in range(w):
            real = ~pads[d]
            _, by_key = np.unique(sk[d, real], return_counts=True)
            _, by_src = np.unique(sk[d, real] * w + si[d, real] // n,
                                  return_counts=True)
            cross += (by_key ** 2).sum() - (by_src ** 2).sum()
        assert cross // 2 > 100_000
    rc, pw = rcounts.numpy(), payload.shape[-1]
    rows = u32.to_numpy(got[2]).reshape(w, -1, pw)
    if CASES[name][2] == "all_full":
        assert (rc == cap).all()
    if CASES[name][2] == "all_empty":
        # worker 1 received nothing: every slot takes block 0's slot 0,
        # the pad id and producer 0's last row
        assert (rc[1] == 0).all() and pads[1].all()
        np.testing.assert_array_equal(
            rows[1], np.broadcast_to(payload[n - 1], rows[1].shape))
    if CASES[name][2] == "pad_keys":
        real = ~pads[w - 1]
        assert (sk[w - 1][real] == PAD).sum() > 100
    if CASES[name][2] == "first_full":
        assert rc[0, 0] == cap and (rc[0, 1:] < cap).all()
        # worker 0's pads carry the row of block 1's first pad, which
        # is source 1's last row, not source 0's
        np.testing.assert_array_equal(
            rows[0][pads[0]],
            np.broadcast_to(payload[2 * n - 1], rows[0][pads[0]].shape))


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


def test_gather_by_slot_takes_pads_from_the_first_pad_of_arrival():
    # two destinations, three sources of C = 4 slots, n = 5 rows each
    w, cap, n, pw = 2, 4, 5, 3
    payload = torch.arange(3 * n * pw, dtype=torch.int32).reshape(3, n, pw)
    rcounts = torch.tensor([[4, 2, 1], [4, 4, 4]], dtype=torch.int32)
    slots = tpay.arrival_slots(rcounts, cap)
    recv = torch.where(slots == u32.PAD, u32.PAD,
                       # block p of destination d: ids of producer p, and
                       # one id of producer 0 sent by producer 2
                       torch.tensor([[[0, 1, 2, 3], [5, 6, 7, 8],
                                      [0, 11, 12, 13]],
                                     [[4, 3, 2, 1], [9, 8, 7, 6],
                                      [14, 13, 12, -(1 << 31) + 10]]],
                                    dtype=torch.int32)).reshape(w, -1)
    merged = torch.tensor([[8, 3, 4, 0, 1, 5, 2, -1, -1, -1, -1, -1],
                           [11, 0, 5, 6, 3, 2, 1, 4, 7, 8, 9, 10]],
                          dtype=torch.int32)
    ids, rows = tpay.gather_by_slot(recv, payload, merged, rcounts)
    # destination 0's first pad is block 1's slot 6 (block 0 is full):
    # the pad id, and producer 1's last row
    assert ids.tolist() == [[0, 3, 5, 0, 1, 6, 2] + [-1] * 5,
                            [-(1 << 31) + 10, 4, 8, 7, 1, 2, 3, 9, 6, 14,
                             13, 12]]
    flat = payload.reshape(-1, pw)
    # ids foreign to the block's producer take its last row: 0 in block
    # 2 of destination 0, 0x8000000A in block 2 of destination 1
    assert torch.equal(rows[0], flat[[14, 3, 5, 0, 1, 6, 2] + [9] * 5])
    assert torch.equal(rows[1],
                       flat[[14, 4, 8, 7, 1, 2, 3, 9, 6, 14, 13, 12]])


def test_gather_by_slot_refuses_more_than_2_to_the_31_rows():
    ids = torch.zeros((1, 2), dtype=torch.int32)
    # two producers of 2^30 + 1 rows, as a view of one row
    payload = torch.zeros((1, 1, 1), dtype=torch.int32).expand(
        2, (1 << 30) + 1, 1)
    with pytest.raises(ValueError, match="2\\^31"):
        tpay.gather_by_slot(ids, payload, ids,
                            torch.ones((1, 2), dtype=torch.int32))


def test_the_int32_row_form_is_local_rows():
    """Without a mesh the gather works out each slot's input row on the
    int32 bits: the row local_rows gives on int64 carriers, for ids in
    the producer's range, below it, above it and at the pad."""
    n, w_src = 6, 3
    blocks = [[p * n, p * n + 2, p * n + n - 1,  # in range
               (p * n - 1) % (1 << 32), 1,  # below it (in it for p = 0)
               p * n + n, (1 << 31) + 3, PAD - 1,  # above it
               PAD] for p in range(w_src)]
    cap = len(blocks[0])
    recv = u32.from_numpy(np.array(blocks, np.uint32).reshape(1, -1), "cpu")
    payload = torch.arange(w_src * n, dtype=torch.int32).reshape(w_src, n, 1)
    rcounts = torch.full((1, w_src), cap, dtype=torch.int32)
    merged = torch.arange(w_src * cap, dtype=torch.int32)[None]
    ids, rows = tpay.gather_by_slot(recv, payload, merged, rcounts)
    assert torch.equal(ids, recv)
    first = torch.arange(w_src, dtype=torch.int64).repeat_interleave(cap) * n
    want = first + tpay.local_rows(recv[0], first, n)
    assert rows[0, :, 0].tolist() == want.tolist()
    # in range: the id's own row; elsewhere the producer's last
    assert want.reshape(w_src, cap)[1].tolist() == [6, 8, 11] + [11] * 6


def _gather_args(w=2, w_src=3, cap=4, n=5, pw=3):
    recv = torch.arange(w * w_src * cap, dtype=torch.int32).reshape(w, -1)
    slots = torch.arange(w_src * cap, dtype=torch.int32).flip(0).repeat(
        w, 1)
    rcounts = torch.full((w, w_src), cap, dtype=torch.int32)
    rows = torch.zeros((w_src, n, pw), dtype=torch.int32)
    return recv, rows, slots, rcounts


@pytest.mark.parametrize("bad,error", [
    (lambda a: (a[0].to(torch.int64), *a[1:]), TypeError),
    (lambda a: (a[0], a[1].to(torch.int64), *a[2:]), TypeError),
    (lambda a: (*a[:3], a[3].to(torch.int64)), TypeError),
    (lambda a: (a[0], a[1], a[2][:, :-1].contiguous(), a[3]), ValueError),
    (lambda a: (a[0][:, :-1].contiguous(), a[1], a[2][:, :-1].contiguous(),
                a[3]), ValueError),  # W_src does not divide m
    (lambda a: (*a[:3], a[3][:1].contiguous()), ValueError),
    (lambda a: (a[0], a[1][:2].contiguous(), *a[2:]), ValueError),
    (lambda a: (a[0], a[1].reshape(-1, 3), *a[2:]), ValueError),
    (lambda a: (a[0].t().contiguous().t(), *a[1:]), ValueError),
    (lambda a: (a[0], a[1].transpose(0, 1), *a[2:]), ValueError),
], ids=["ids_int64", "rows_int64", "rcounts_int64", "slots_shape",
        "blocks_ragged", "rcounts_rows", "rows_producers", "rows_flat",
        "ids_strided", "rows_strided"])
def test_the_slot_gather_refuses_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        gather_slot_rows(*bad(_gather_args()), from_input=True)


def test_the_slot_gather_refuses_received_rows_of_another_count():
    recv, _, slots, rcounts = _gather_args()
    for rows in (torch.zeros((2, 11, 3), dtype=torch.int32),
                 torch.zeros((24,), dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            gather_slot_rows(recv, rows, slots, rcounts, from_input=False)


@pytest.mark.parametrize("from_input", [True, False])
def test_a_cpu_tensor_takes_the_plain_version(from_input, monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel")

    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(_build, "count_launch", no_launch)
    recv, rows, slots, rcounts = _gather_args()
    if not from_input:
        rows = torch.arange(recv.numel() * 3, dtype=torch.int32).reshape(
            2, 3, 4, 3)
    got = gather_slot_rows(recv, rows, slots, rcounts, from_input=from_input)
    want = gather_slot_rows_plain(recv, rows, slots, rcounts,
                                  from_input=from_input)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("where", ["no_mesh", "rank_mesh"])
def test_one_launch_a_gather_logs_slots_input_rows_and_width(
        where, tmp_path, monkeypatch):
    """Off the CPU `gather_by_slot` is one kernel launch, logged as (S,
    R, pw): S slots gathered, R input rows read (W_src * n without a
    mesh, 0 on one, where the rows are the received blocks). The launch
    itself is stubbed: meta tensors, nothing runs."""
    w, w_src, cap, n, pw = 8, 8, 16, 12, 23
    meta = dict(dtype=torch.int32, device="meta")
    recv = torch.empty((w, w_src * cap), **meta)
    rcounts = torch.empty((w, w_src), **meta)
    log = []
    monkeypatch.setattr(_build, "launch", lambda *a: None)
    monkeypatch.setattr(_build, "count_launch",
                        lambda fn, attr="launches", n=1, shape=None:
                        log.append((fn.__name__, attr, n, shape)))
    if where == "no_mesh":
        rows = torch.empty((w_src, n, pw), **meta)
        ids, out = tpay.gather_by_slot(recv, rows, recv, rcounts)
        assert log == [("gather_slot_rows", "launches", 1,
                        (w * w_src * cap, w_src * n, pw))]
    else:
        rows = torch.empty((w, w_src, cap, pw), **meta)
        mesh = _world_of_one(w, tmp_path)
        try:
            ids, out = tpay.gather_by_slot(recv, rows, recv, rcounts,
                                           mesh=mesh)
        finally:
            mesh.close()
        assert log == [("gather_slot_rows", "launches", 1,
                        (w * w_src * cap, 0, pw))]
    assert ids.shape == recv.shape and out.shape == (w, w_src * cap, pw)


def test_a_rank_mesh_keeps_pack_exchange_and_join(tmp_path, monkeypatch):
    """One gloo rank holding all W workers: the rows are packed and
    exchanged in their spans, and the output is the one-process sort's."""
    keys, ids, payload, w, cf = _inputs("first_full_w8_pw23")
    kw = dict(num_workers=w, capacity_factor=cf)
    plain = texo.distributed_sort_payload(keys, ids, payload, device="cpu",
                                          **kw)
    monkeypatch.setattr(device, "counters", MetricsRegistry())
    mesh = _world_of_one(w, tmp_path)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ranked = texo.distributed_sort_payload(keys, ids, payload,
                                                   mesh=mesh, **kw)
    finally:
        mesh.close()
    _assert_same(ranked, plain)
    assert device.counters.counter_value("exchange.records") == N
    spans = [e.name() for e in sorted(
        prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
        if e.is_user_annotation() and e.name().startswith("payload.")]
    assert spans == ["payload.pack", "payload.exchange", "payload.join",
                     "payload.join"]


# The aten ops that each `payload.join` range dispatches without a mesh
# (its direct children on the profiler's tree): the slot build before
# the merge, then the gather by slot after it.
SLOT_BUILD = "arange reshape arange unsqueeze lt where".split()
GATHER = """reshape
    arange unsqueeze mul add reshape lt minimum where reshape
    arange unsqueeze mul
    to arange mul lt add where amin eq to where
    add reshape
    reshape index_select reshape
    reshape index_select unsqueeze
    reshape reshape index_select reshape
    reshape""".split()


@pytest.mark.parametrize("key_bytes", [4, 10])
def test_the_join_dispatches_the_pinned_ops(key_bytes):
    keys, ids, payload, w, cf = _inputs("ties_w8_pw8")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        texo.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                      capacity_factor=cf, device="cpu",
                                      key_bytes=key_bytes)
    joins = [[c.name for c in e.cpu_children] for e in prof.events()
             if e.name == "payload.join"]
    assert joins == [["aten::" + op for op in ops]
                     for ops in (SLOT_BUILD, GATHER)]
