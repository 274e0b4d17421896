"""The whole 10-byte key: `distributed_sort_payload(..., key_bytes=10)`
against the plain reference (tests/key10_reference.py).

Records are laid out as the port holds the rules' 100 bytes: key bytes
0-3 in `keys`, bytes 4-7 in payload word 0, bytes 8-9 in the high half
of payload word 1 (core/keytail.py). Each worker's valid prefix must
hold the reference's records of its key range, in the rules' order,
bit for bit; the keys and everything past the valid prefix must be the
4-byte sort's, which the key-tail stage leaves alone.
"""
import hashlib

import numpy as np
import pytest
import torch

from key10_reference import sort_split
from repro_torch.core import exoshuffle, keytail
from repro_torch.kernels import u32

torch.set_num_threads(2)

PW = 23  # payload words of a 100-byte record


def _records(seed, n, words, tails):
    """n records: key words drawn from `words`, key bytes 4-9 from
    `tails` (a list of (word 0, high half of word 1)), the rest random;
    ids 0..n-1. numpy uint32."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(words, dtype=np.uint32)[rng.integers(0, len(words), n)]
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint64).astype(
        np.uint32)
    t = np.asarray(tails, dtype=np.uint64)[rng.integers(0, len(tails), n)]
    payload[:, 0] = t[:, 0].astype(np.uint32)
    payload[:, 1] = ((t[:, 1] << np.uint64(16))
                     | (payload[:, 1] & np.uint32(0xFFFF))).astype(np.uint32)
    return keys, np.arange(n, dtype=np.uint32), payload


def _spread(w, per):
    """`per` key words in each of W equal ranges, the range's first and
    last words among them."""
    span = (1 << 32) // w
    out = []
    for d in range(w):
        lo, hi = d * span, (d + 1) * span - 1
        out += [lo, hi] + [lo + (hi - lo) * (j + 1) // per
                           for j in range(per - 2)]
    return out


def _tails(seed, count, top=0xFFFF):
    rng = np.random.default_rng(seed)
    return [(int(a), int(b)) for a, b in zip(
        rng.integers(0, 2**32, count, dtype=np.uint64),
        rng.integers(0, top + 1, count))]


# name: (W, n, key words, tails, capacity_factor)
CASES = {
    # seeded random records with ties at every depth of the key
    "random_w1": (1, 1 << 11, _spread(1, 40), _tails(1, 6), 1.5),
    "random_w2": (2, 1 << 11, _spread(2, 24), _tails(2, 6), 1.5),
    "random_w8": (8, 1 << 12, _spread(8, 12), _tails(3, 6), 1.5),
    # every key shares its leading 4 bytes: bytes 4-9 alone set the order
    "one_word_w1": (1, 1 << 11, [0x9E3779B9], _tails(4, 500), 1.5),
    "one_word_w8": (8, 1 << 11, [0x9E3779B9], _tails(5, 500), 8.0),
    # keys that differ only in byte 9
    "byte9_w2": (2, 1 << 11, _spread(2, 8),
                 [(0x01020304, 0x0100 | b) for b in range(256)], 1.5),
    # keys equal in all ten bytes: the id breaks every tie
    "equal_keys_w8": (8, 1 << 12, _spread(8, 4), [(0xFFFFFFFF, 0xFFFF)],
                      1.5),
    # runs at the top of each worker's range, the last at 0xFFFFFFFF,
    # the pads' own key word, end at the valid prefix
    "at_the_pads_w8": (8, 1 << 12, [(d + 1) * (1 << 29) - 1
                                    for d in range(8)], _tails(6, 3), 1.5),
}


def _sort(name, key_bytes, impl="kernel", mode="through"):
    w, n, words, tails, cf = CASES[name]
    keys, ids, payload = _records(sum(map(ord, name)), n, words, tails)
    out = exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, capacity_factor=cf, impl=impl,
        mode=mode, device="cpu", key_bytes=key_bytes)
    return (keys, ids, payload), out


def _segments(out, w):
    mk, mv, pout, valid, _ = out
    m = mk.shape[0] // w
    return [(mk[d * m:d * m + int(valid[d])], mv[d * m:d * m + int(valid[d])],
             pout[d * m:d * m + int(valid[d])]) for d in range(w)]


def _check(name, impl, mode):
    w = CASES[name][0]
    (keys, ids, payload), out = _sort(name, 10, impl, mode)
    assert not bool(out[4])
    want = sort_split(*(u32.from_numpy(a, "cpu") for a in (keys, ids,
                                                           payload)), w)
    for d, (got, ref) in enumerate(zip(_segments(out, w), want)):
        for a, b, what in zip(got, ref, ("keys", "ids", "payload")):
            assert torch.equal(a, b), f"{name}: worker {d}'s {what}"
    # the stage moves ids and rows within runs: keys, valid counts and
    # every pad are the 4-byte sort's
    _, four = _sort(name, 4, impl, mode)
    assert torch.equal(out[0], four[0]) and torch.equal(out[3], four[3])
    m = out[0].shape[0] // w
    for d in range(w):
        pads = slice(d * m + int(out[3][d]), (d + 1) * m)
        assert torch.equal(out[1][pads], four[1][pads])
        if mode == "through":
            assert torch.equal(out[2][pads], four[2][pads])
    return out, four


@pytest.mark.parametrize("name", list(CASES))
def test_the_wide_key_sort_matches_the_reference(name):
    out, four = _check(name, "kernel", "through")
    if name != "equal_keys_w8":
        # the 4-byte order differs: the cases reach past the key word
        assert not torch.equal(out[1], four[1])


@pytest.mark.parametrize("name,impl,mode", [
    ("random_w8", "ref", "through"), ("random_w2", "ref", "late"),
    ("at_the_pads_w8", "kernel", "late")])
def test_the_other_impl_and_mode(name, impl, mode):
    _check(name, impl, mode)


def test_full_workers_with_runs_on_both_sides_of_their_boundary():
    # capacity factor 1.0 and every source sending C records to each
    # worker: no pads at all, and worker 0's last run (key word
    # 2^31 - 1) meets worker 1's first (2^31) across the boundary
    w, n = 2, 1 << 11
    keys, ids, payload = _records(11, n, [0], _tails(11, 4))
    keys[0::2] = np.array([2**31 - 1, 9, 2**31 - 1, 77],
                          dtype=np.uint32)[np.arange(n // 2) % 4]
    keys[1::2] = np.array([2**31, 2**31, 2**32 - 5],
                          dtype=np.uint32)[np.arange(n // 2) % 3]
    out = exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, capacity_factor=1.0,
        device="cpu", key_bytes=10)
    assert not bool(out[4])
    assert out[3].tolist() == [out[0].shape[0] // w] * w  # no pads
    want = sort_split(*(u32.from_numpy(a, "cpu") for a in (keys, ids,
                                                           payload)), w)
    for got, ref in zip(_segments(out, w), want):
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_the_wide_key_sort_over_two_ranks():
    # two gloo ranks of four workers each: the stage runs on each rank's
    # workers, and the ranks' outputs in order are the one-process sort's
    import mesh_ranks
    from repro_torch.launch.mesh import spawn_ranks

    w, n, words, tails, _ = CASES["random_w8"]
    keys, ids, payload = _records(17, n, words, tails)
    ranks = spawn_ranks(mesh_ranks.key10_sort, 2, keys, ids, payload)
    one = exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, device="cpu", key_bytes=10)
    assert [r[-1] for r in ranks] == [False, False] and not one[-1]
    for i in range(4):
        np.testing.assert_array_equal(
            np.concatenate([r[i] for r in ranks]), one[i].numpy())


def test_a_run_past_the_capacity_sets_overflow():
    # 2^13 records of one key word at W = 1: 2^13 - 1 pairs of equal
    # words over a capacity of PAIR_FLOOR = 2^12
    n = 1 << 13
    keys, ids, payload = _records(7, n, [12345], _tails(7, 900))
    assert keytail.pair_capacity(n, 1, 1, 1 << 14, 1.5) == keytail.PAIR_FLOOR
    kw = dict(num_workers=1, device="cpu")
    four = exoshuffle.distributed_sort_payload(keys, ids, payload, **kw)
    wide = exoshuffle.distributed_sort_payload(keys, ids, payload,
                                               key_bytes=10, **kw)
    assert not bool(four[4]) and bool(wide[4])


def test_the_capacity_follows_the_uniform_mean():
    # indy10: 2^23 records a worker, W = 8 held: 2^19 pairs expected
    assert keytail.pair_capacity(1 << 23, 8, 8, 1 << 24, 1.5) == 3 << 18
    assert keytail.pair_capacity(100, 8, 8, 64, 1.5) == 8 * 63
    assert keytail.pair_capacity(1 << 10, 8, 8, 1 << 12, 1.5) == \
        keytail.PAIR_FLOOR


def test_key_bytes_is_checked():
    keys, ids, payload = _records(9, 64, [1], [(0, 0)])
    with pytest.raises(ValueError, match="key_bytes"):
        exoshuffle.distributed_sort_payload(keys, ids, payload,
                                            num_workers=2, device="cpu",
                                            key_bytes=8)
    with pytest.raises(ValueError, match="payload words"):
        exoshuffle.distributed_sort_payload(keys, ids, payload[:, :1],
                                            num_workers=2, device="cpu",
                                            key_bytes=10)


# sha256 of the 4-byte sort's whole output on one seeded case (keys,
# ids, payload rows, valid counts, overflow), taken before the key-tail
# stage existed
FOUR_BYTE_DIGEST = ("73b11620deff0edb607c677eeec5d7a625d59f97da198bfefbc6ec8f"
                    "335a48a2")


def test_the_four_byte_path_is_unchanged():
    rng = np.random.default_rng(20261018)
    n, w = 1 << 12, 8
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    keys[1::2] = keys[0::2]  # pairs of equal key words
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint64).astype(
        np.uint32)
    ids = np.arange(n, dtype=np.uint32)
    mk, mv, pout, valid, ovf = exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, device="cpu")
    h = hashlib.sha256()
    for t in (mk, mv, pout, valid):
        h.update(t.numpy().tobytes())
    h.update(bytes([bool(ovf)]))
    assert h.hexdigest() == FOUR_BYTE_DIGEST
