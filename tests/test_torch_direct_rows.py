"""The through mode without a mesh (core/payload.gather_rows_by_slot):
each output row gathered once, straight from its producer's input.

The oracle is the through mode's mesh path, called with no mesh: the
rows of each sent block packed beside its headers and exchanged
(`exoshuffle._send_payload_rows`), the (key, arrival slot) merge, then
`join_by_slot` on the received blocks, and the key-tail stage after it
where the key is 10 bytes. The whole output must agree bit for bit, pad
rows included, on test_torch_slot_join's cases (equal keys across
source blocks, an overflowing zipf input, the first pad of arrival order
in a block after the first), on ids outside the id // n layout, and
with key_bytes=10. The counter `payload.direct_rows` advances by the
slots gathered (wl·W·C) a call, and only without a mesh: over a rank
mesh (one gloo rank here) the three-stage path runs in its own spans.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import exoshuffle as texo
from repro_torch.core import keytail, sortlib
from repro_torch.core import payload as tpay
from repro_torch.kernels import u32
from repro_torch.launch import mesh as tmesh
from repro_torch.obs import device
from repro_torch.obs.metrics import MetricsRegistry
from test_torch_device_spans import SIZES
from test_torch_slot_join import CASES, N, _inputs

torch.set_num_threads(2)

PAD = 0xFFFFFFFF


def _mesh_path(keys, ids, payload, w, cf, key_bytes=4):
    """The mesh path's composition with mesh=None: (mk, mv, pout, valid,
    overflow) as distributed_sort_payload returns them."""
    n = len(keys) // w
    cfg = texo.ShuffleConfig(num_workers=w, capacity_factor=cf)
    cap = cfg.block_capacity(n)
    k, i = u32.from_numpy(keys, "cpu"), u32.from_numpy(ids, "cpu")
    p = u32.from_numpy(payload, "cpu")
    pw = p.shape[-1]
    bv, rk, rv, rcounts, ovf = texo._exchange(
        k.reshape(w, n), i.reshape(w, n), cfg=cfg, capacity=cap)
    rp = texo._send_payload_rows(bv, p.reshape(w, n, pw), n=n, capacity=cap,
                                 mesh=None)
    mk, ms = sortlib.merge_runs(rk, tpay.arrival_slots(rcounts, cap))
    mv, pout = tpay.join_by_slot(rv.reshape(w, -1), rp.reshape(w, -1, pw),
                                 ms, rcounts)
    valid = rcounts.sum(dim=-1).to(torch.int32)
    if key_bytes == 10:
        _, tail_ovf = keytail.order_key_tails(
            mk, mv, pout, valid,
            keytail.pair_capacity(n, w, w, mk.shape[-1], cf))
        ovf = ovf | tail_ovf
    return (mk.reshape(-1), mv.reshape(-1), pout.reshape(-1, pw), valid,
            bool(ovf.any()))


def _foreign_ids(name):
    """A case's input with ids that break the id // n == producer layout:
    a permutation, a quarter of them moved above 2^31, one the pad id."""
    keys, ids, payload, w, cf = _inputs(name)
    rng = np.random.default_rng(11)
    ids = rng.permutation(ids).astype(np.uint32)
    ids[rng.random(ids.size) < 0.25] |= np.uint32(1 << 31)
    ids[rng.integers(0, ids.size)] = PAD
    return keys, ids, payload, w, cf


def _assert_same(got, want):
    assert len(got) == len(want) == 5
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[4] is want[4]


# name: (the input, key bytes)
DIRECT = {name: (_inputs, 4) for name in CASES}
DIRECT.update({
    "foreign_ids_ties_w8_pw23": (_foreign_ids, 4),
    "foreign_ids_zipf_w8_pw8_overflow": (_foreign_ids, 4),
    "foreign_ids_first_full_w2_pw8": (_foreign_ids, 4),
    "key10_ties_w8_pw8": (_inputs, 10),
    "key10_ties_w2_pw23": (_inputs, 10),
    "key10_first_full_w8_pw23": (_inputs, 10),
})


def _case(name):
    make, key_bytes = DIRECT[name]
    base = name.removeprefix("foreign_ids_").removeprefix("key10_")
    return (*make(base), key_bytes)


@pytest.mark.parametrize("name", list(DIRECT))
def test_direct_rows_match_the_mesh_paths_composition(name):
    keys, ids, payload, w, cf, key_bytes = _case(name)
    got = texo.distributed_sort_payload(
        keys, ids, payload, num_workers=w, capacity_factor=cf, device="cpu",
        key_bytes=key_bytes)
    want = _mesh_path(keys, ids, payload, w, cf, key_bytes)
    _assert_same(got, want)
    assert got[4] is name.endswith("overflow")
    mv = u32.to_numpy(got[1]).reshape(w, -1)
    pads = mv == PAD
    assert pads.any()
    if name.startswith("foreign_ids"):
        # most records' ids lie outside their producer's rows
        producer = np.arange(ids.size) // (N // w)
        assert (ids // (N // w) != producer).mean() > 0.5
    if name.startswith("key10"):
        # the key-tail stage had runs of equal key words to order
        mk = u32.to_numpy(got[0]).reshape(w, -1)
        assert (mk[:, 1:] == mk[:, :-1])[~pads[:, 1:]].sum() > 100


def test_gather_rows_by_slot_takes_pads_from_the_first_pad_of_arrival():
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
    ids, rows = tpay.gather_rows_by_slot(recv, payload, merged, rcounts, n)
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


def test_gather_rows_by_slot_refuses_more_than_2_to_the_31_rows():
    ids = torch.zeros((1, 2), dtype=torch.int32)
    payload = torch.zeros((2, 1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        tpay.gather_rows_by_slot(ids, payload, ids, torch.ones(
            (1, 2), dtype=torch.int32), (1 << 30) + 1)


@pytest.mark.parametrize("mode", ["through", "late"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"w{s[0]}_n{s[1]}")
def test_direct_rows_counter_advances_per_call(mode, size, monkeypatch):
    w, total, factor, capacity = size
    keys, ids, payload, *_ = _inputs("ties_w2_pw8")
    keys, ids, payload = keys[:total], ids[:total], payload[:total]
    monkeypatch.setattr(device, "counters", MetricsRegistry())
    for calls in (1, 2):
        texo.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                      mode=mode, capacity_factor=factor,
                                      device="cpu")
        want = calls * w * w * capacity if mode == "through" else 0
        assert device.counters.counter_value("payload.direct_rows") == want


def test_a_rank_mesh_keeps_pack_exchange_and_join(tmp_path, monkeypatch):
    """One gloo rank holding all W workers: the rows are packed and
    exchanged in their spans, nothing is counted as gathered directly,
    and the output is the one-process sort's."""
    keys, ids, payload, w, cf = _inputs("first_full_w8_pw23")
    kw = dict(num_workers=w, capacity_factor=cf)
    plain = texo.distributed_sort_payload(keys, ids, payload, device="cpu",
                                          **kw)
    monkeypatch.setattr(device, "counters", MetricsRegistry())
    mesh = tmesh.init_rank_mesh(w, backend="gloo", device="cpu", rank=0,
                                world=1, store_path=str(tmp_path / "s"))
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ranked = texo.distributed_sort_payload(keys, ids, payload,
                                                   mesh=mesh, **kw)
    finally:
        mesh.close()
    _assert_same(ranked, plain)
    assert device.counters.counter_value("payload.direct_rows") == 0
    assert device.counters.counter_value("exchange.records") == N
    spans = [e.name() for e in sorted(
        prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
        if e.is_user_annotation() and e.name().startswith("payload.")]
    assert spans == ["payload.pack", "payload.exchange", "payload.join",
                     "payload.join"]
