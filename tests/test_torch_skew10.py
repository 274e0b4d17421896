"""CloudSort's Daytona input on the port: `distributed_sort_payload(...,
key_bytes=10, sample_fraction=f)` against the plain reference's whole
order (tests/key10_reference.sort_records).

A Daytona sort is told nothing of the key distribution. With f > 0 the
sort samples its worker boundaries from each call's own sorted keys, so
its workers' key ranges are its own: the reference therefore sorts all
records with no split, and the workers' valid prefixes, concatenated in
worker order, must be that whole order, bit for bit. The input is the
Daytona skew on a random 80-bit key (K >> s, s uniform over 0..23), plus
one hot key word whose run fits one worker: an equal split of the key
word sends most records to worker 0 and overflows, and most records lie
in runs of equal key words, far more than the key-tail stage's buffer
under the equal split holds. With f = 0 the call is the parent's path,
aten op for aten op.
"""
import hashlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from key10_reference import sort_records
from repro_torch.core import collectives, exoshuffle, keyspace, keytail
from repro_torch.kernels import u32
from repro_torch.obs import device

torch.set_num_threads(2)

PW = 23  # payload words of a 100-byte record
W = 8
N = 1 << 17  # f = 2^-10 leaves MIN_SAMPLES keys of each worker
HOT_WORD = 0x00ABCDEF  # among the dense low words of the skew


def skewed(seed, n=N, hot_share=1 / 32, hot_tails=8):
    """n records (numpy uint32 keys, ids 0..n-1, payload) with the Daytona
    skew on a random 80-bit key, and one hot key word taken by about
    `hot_share` of them, whose key bytes 4-9 come from `hot_tails` random
    values, so that some records tie in all ten bytes."""
    rng = np.random.default_rng(seed)
    hi, lo = (rng.integers(0, 2**32, n, dtype=np.uint64) for _ in range(2))
    tail = rng.integers(0, 2**16, n, dtype=np.uint64)
    s = rng.integers(0, 24, n).astype(np.uint64)
    one, mask = np.uint64(1), np.uint64(0xFFFFFFFF)
    keys = hi >> s
    w0 = ((lo >> s) | ((hi & ((one << s) - one)) << (np.uint64(32) - s))) \
        & mask
    t = (((lo << np.uint64(16)) | tail) >> s) & np.uint64(0xFFFF)
    hot = rng.random(n) < hot_share
    pick = rng.integers(0, hot_tails, n)[hot]
    keys[hot] = HOT_WORD
    w0[hot] = rng.integers(0, 2**32, hot_tails, dtype=np.uint64)[pick]
    t[hot] = rng.integers(0, 2**16, hot_tails, dtype=np.uint64)[pick]
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint64)
    payload[:, 0] = w0
    payload[:, 1] = (t << np.uint64(16)) | (payload[:, 1]
                                            & np.uint64(0xFFFF))
    return (keys.astype(np.uint32), np.arange(n, dtype=np.uint32),
            payload.astype(np.uint32))


def _sort(records, w=W, **kw):
    return exoshuffle.distributed_sort_payload(
        *records, num_workers=w, device="cpu", **dict(dict(key_bytes=10),
                                                      **kw))


def _prefixes(out, w=W):
    """The workers' valid prefixes of (keys, ids, payload), concatenated
    in worker order."""
    mk, mv, pout, valid, _ = out
    m = mk.shape[0] // w
    parts = [slice(d * m, d * m + int(valid[d])) for d in range(w)]
    return tuple(torch.cat([t[p] for p in parts]) for t in (mk, mv, pout))


def _assert_whole_order(out, records, w=W):
    want = sort_records(*(u32.from_numpy(a, "cpu") for a in records))
    for got, ref, what in zip(_prefixes(out, w), want,
                              ("keys", "ids", "payload")):
        assert torch.equal(got, ref), what


FRACTIONS = {"2^-4": 2**-4, "2^-10": 2**-10, "1": 1.0}


@pytest.mark.parametrize("fraction", FRACTIONS.values(), ids=FRACTIONS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sampled_splitters_give_the_whole_order(seed, fraction):
    records = skewed(seed)
    out = _sort(records, sample_fraction=fraction)
    assert not bool(out[4])
    _assert_whole_order(out, records)
    # the ties far pass what the stage holds under the equal split
    words = np.sort(records[0])
    pairs = int((words[1:] == words[:-1]).sum())
    assert pairs > 4 * keytail.pair_capacity(N // W, W, W, out[0].shape[0]
                                             // W, 1.5)
    # the hot word's run lies in one worker, which holds it whole
    mk = out[0].view(W, -1)
    holders = [d for d in range(W)
               if bool((mk[d, :int(out[3][d])] == HOT_WORD).any())]
    assert len(holders) == 1
    assert int((mk[holders[0]] == HOT_WORD).sum()) == \
        int((records[0] == HOT_WORD).sum())


def test_the_equal_split_overflows_on_the_skew():
    out = _sort(skewed(1))
    assert bool(out[4])
    assert int(out[3][0]) > N // 2  # most records fall to worker 0


def test_the_late_mode_and_the_four_byte_order_sample_too():
    records = skewed(4, n=1 << 14)
    late = _sort(records, mode="late", sample_fraction=2**-4)
    assert not bool(late[4])
    _assert_whole_order(late, records)
    four = _sort(records, key_bytes=4, sample_fraction=2**-4)
    assert not bool(four[4])
    keys, ids, _ = _prefixes(four)
    order = np.lexsort((records[1], records[0]))  # by key word, then id
    np.testing.assert_array_equal(u32.to_numpy(keys), records[0][order])
    np.testing.assert_array_equal(u32.to_numpy(ids), records[1][order])


def test_a_run_past_the_equal_splits_capacity_is_held():
    # 2^13 records of one key word at W = 1: 2^13 - 1 pairs of equal
    # words, which overflow PAIR_FLOOR = 2^12 under the equal split
    rng = np.random.default_rng(7)
    n = 1 << 13
    keys = np.full(n, 12345, dtype=np.uint32)
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint64).astype(
        np.uint32)
    payload[:, 1] &= 0x0FFFFFFF  # ties in key bytes 8-9 as well
    payload[:, 0] %= 97  # and in bytes 4-7
    records = (keys, np.arange(n, dtype=np.uint32), payload)
    assert bool(_sort(records, w=1)[4])
    out = _sort(records, w=1, sample_fraction=1.0)
    assert not bool(out[4])
    _assert_whole_order(out, records, w=1)


def test_the_sort_over_two_ranks_is_the_one_process_sort():
    # two gloo ranks of four workers each: every rank gathers every
    # rank's sample, so both split where the one process does
    import mesh_ranks
    from repro_torch.launch.mesh import spawn_ranks

    records = skewed(5, n=1 << 14)
    ranks = spawn_ranks(mesh_ranks.key10_sort, 2, *records, 2**-4)
    one = _sort(records, sample_fraction=2**-4)
    assert [r[-1] for r in ranks] == [False, False] and not one[-1]
    for i in range(4):
        np.testing.assert_array_equal(
            np.concatenate([r[i] for r in ranks]), one[i].numpy())


def test_the_peak_count_adds_the_busiest_worker(monkeypatch):
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    records = skewed(6, n=1 << 14)
    _sort(records)
    assert device.device_counts.value("exchange.peak_worker_records") is None
    want = 0
    for calls in (1, 2):
        out = _sort(records, sample_fraction=2**-4)
        want += int(out[3].max())
        assert device.device_counts.value(
            "exchange.peak_worker_records") == want
    assert want < 2 * 1.05 * (1 << 14) // W  # within 5% of the mean


def _span_names(**kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sort(skewed(8, n=1 << 12), **kw)
    return [e.name for e in prof.events() if e.name.startswith("sort.")]


def test_the_sample_span_opens_only_when_sampling():
    plain = _span_names()
    sampled = _span_names(sample_fraction=2**-4)
    assert "sort.sample" not in plain
    assert sampled == plain[:1] + ["sort.sample"] + plain[1:]


def _parent_inputs(n=1 << 12, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    keys[1::2] = keys[0::2]  # pairs of equal key words
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint64).astype(
        np.uint32)
    return keys, np.arange(n, dtype=np.uint32), payload


# sha256 of every range's direct aten children and nested ranges, in the
# order the profiler lists them ("name: child child ..." a line), of one
# W = 8 call on _parent_inputs(), taken on the tree before the sort
# could sample its splitters; and how many children they have in all
PARENT_OPS = {
    4: ("88668d0c24762ed7b7aeb2935c27451ab9e1414b70e489e7214f06ed498ca840",
        1360),
    10: ("a00ccb34ce638272b39a5983c1853d8003c8c3d0b419a8e839e135c9248c97b5",
         1436),
}


@pytest.mark.parametrize("given", [False, True],
                         ids=["default", "sample_fraction_0"])
@pytest.mark.parametrize("key_bytes", [4, 10])
def test_sample_fraction_zero_dispatches_the_parents_ops(key_bytes, given,
                                                        monkeypatch):
    # a count's first addition clones where later ones add: start afresh
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    kw = dict(sample_fraction=0.0) if given else {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exoshuffle.distributed_sort_payload(
            *_parent_inputs(), num_workers=8, device="cpu",
            key_bytes=key_bytes, **kw)
    ranges = [(e.name, [c.name for c in e.cpu_children])
              for e in prof.events() if not e.name.startswith("aten::")]
    text = "\n".join(n + ": " + " ".join(c) for n, c in ranges)
    got = (hashlib.sha256(text.encode()).hexdigest(),
           sum(len(c) for _, c in ranges))
    assert got == PARENT_OPS[key_bytes], [(n, len(c)) for n, c in ranges]


def test_sample_fraction_is_checked():
    records = skewed(9, n=1 << 10)
    for bad in (-0.5, 1.5):
        with pytest.raises(ValueError, match="sample_fraction"):
            _sort(records, sample_fraction=bad)
    cfg = exoshuffle.ShuffleConfig(num_workers=W,
                                   boundaries=tuple(range(1, W)))
    with pytest.raises(ValueError, match="cfg.boundaries"):
        _sort(records, cfg=cfg, sample_fraction=0.5)


def test_the_splitters_follow_the_sampled_boundaries_rule():
    rng = np.random.default_rng(10)
    sample = u32.from_numpy(rng.integers(0, 2**32, 1000, dtype=np.uint64)
                            .astype(np.uint32), "cpu")
    srt = torch.sort(u32.widen(sample)).values
    for parts in (1, 2, 8, 1000, 1500):
        assert torch.equal(keyspace.sampled_boundaries(sample, parts),
                           u32.narrow(keyspace.quantiles(srt, parts)))
    with pytest.raises(ValueError, match="at least one"):
        keyspace.quantiles(srt[:0], 4)
    # one worker's splitters are its sorted sample's quantiles, and the
    # gather is the sample itself without a mesh
    sk = torch.sort(u32.widen(sample[:512])).values
    cfg = exoshuffle.ShuffleConfig(num_workers=4)
    got = exoshuffle.sampled_worker_boundaries(u32.narrow(sk)[None], 1 / 8,
                                               cfg=cfg)
    assert u32.widen(got).tolist() == sk[4::8][[16, 32, 48]].tolist()
    assert collectives.gather_across(sample) is sample


def test_each_worker_gives_at_least_min_samples():
    # 512 sorted keys a worker at f = 2^-10: step 512 // MIN_SAMPLES
    # = 8 from position 4, so 64 keys and not 1
    rng = np.random.default_rng(11)
    sk = torch.sort(torch.from_numpy(rng.integers(0, 2**32, 512)))
    sk = sk.values
    cfg = exoshuffle.ShuffleConfig(num_workers=4)
    assert exoshuffle.MIN_SAMPLES == 64
    got = exoshuffle.sampled_worker_boundaries(u32.narrow(sk)[None], 2**-10,
                                               cfg=cfg)
    assert u32.widen(got).tolist() == sk[4::8][[16, 32, 48]].tolist()
    # fewer keys than MIN_SAMPLES: every key is sampled
    got = exoshuffle.sampled_worker_boundaries(u32.narrow(sk[:10])[None],
                                               2**-10, cfg=cfg)
    assert u32.widen(got).tolist() == sk[:10][[2, 5, 7]].tolist()
    # so the configuration's fraction splits 2^13 skewed records
    records = skewed(12, n=1 << 13)
    out = _sort(records, sample_fraction=2**-10)
    assert not bool(out[4])
    _assert_whole_order(out, records)


def test_the_stage_capacity_follows_the_splitters():
    shape = (1 << 23, 8, 8, 1 << 24, 1.5)
    assert keytail.stage_capacity(*shape, sampled=False) == \
        keytail.pair_capacity(*shape) == 3 << 18
    assert keytail.stage_capacity(*shape, sampled=True) is None
