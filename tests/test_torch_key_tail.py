"""The key-tail stage at the edges of the card kernel's classes of run
length, against the plain reference of the rules' order
(tests/key10_reference.py), and the stage's wrapper.

On the CPU `core/keytail.order_key_tails` takes the plain version; the
card's kernel (kernels/key_tail.py, csrc/key_tail.cu) orders runs of up
to 32 records in the warp that finds them, runs of up to 512 in the mid
class, longer ones in the large class (rows staged in shared memory up to
2,371 at pw 23 on an H100, sorted whole up to 16,384, merged in scratch
past that; a position key is unique up to 65,536). The cases
here put runs at those edges, at a worker's first and last valid slot,
over a whole worker, and hold the plain stage to the reference there;
chip_smoke holds the kernel to the plain version at the same edges on the
card. The stage's checks raise before anything is launched; the card's
lists and scratch are sized by the kernel's own C code (held on the card
by chip_smoke).
"""
import numpy as np
import pytest
import torch

from key10_reference import sort_records
from repro_torch.core import keytail
from repro_torch.kernels import _build, key_tail, u32

torch.set_num_threads(2)

PW = 23  # payload words of a 100-byte record


def _worker(rng, m, valid, runs, tails=0):
    """One worker of the stage's input: `valid` records in (key word, id)
    order holding runs of equal key words of the given lengths (the first
    at slot 0, the last ending at the last valid slot, the others between
    with single records around them), pads past them. tails > 0 draws key
    bytes 4-9 from that many values, so the id decides among equal keys.
    Returns (keys, ids, payload) numpy uint32 of m slots."""
    lengths = [1] * (valid - sum(runs) - (len(runs) - 1)) + list(runs)
    if len(runs) > 1:  # first run first, last run last, singles between
        lengths = [runs[0]] + [1] * (valid - sum(runs)) + list(runs[1:])
    assert sum(lengths) == valid
    words = np.cumsum(rng.integers(1, 1 << 16, len(lengths), dtype=np.uint64))
    keys = np.repeat(words, lengths).astype(np.uint32)
    ids = np.sort(rng.choice(1 << 31, valid, replace=False)).astype(np.uint32)
    payload = rng.integers(0, 2**32, (valid, PW), dtype=np.uint64).astype(
        np.uint32)
    if tails:
        payload[:, 0] = rng.integers(0, tails, valid)
        payload[:, 1] = (rng.integers(0, tails, valid).astype(np.uint32)
                         << np.uint32(16)) | (payload[:, 1] & 0xFFFF)
    pads = m - valid
    return (np.concatenate([keys, np.full(pads, 0xFFFFFFFF, np.uint32)]),
            np.concatenate([ids, np.full(pads, 0xFFFFFFFF, np.uint32)]),
            np.concatenate([payload, rng.integers(
                0, 2**32, (pads, PW), dtype=np.uint64).astype(np.uint32)]))


def _stage(workers, capacity=None):
    """Run the stage over the workers (each (keys, ids, payload, valid))
    on CPU tensors; returns the inputs and outputs as tensors."""
    keys = torch.stack([u32.from_numpy(w[0], "cpu") for w in workers])
    ids = torch.stack([u32.from_numpy(w[1], "cpu") for w in workers])
    rows = torch.stack([u32.from_numpy(w[2], "cpu") for w in workers])
    valid = torch.tensor([w[3] for w in workers], dtype=torch.int32)
    before = (ids.clone(), rows.clone())
    tied, overflow = keytail.order_key_tails(keys, ids, rows, valid, capacity)
    return keys, before, (ids, rows), valid, tied, overflow


def _check_against_reference(keys, before, after, valid):
    for d in range(keys.shape[0]):
        v = int(valid[d])
        want = sort_records(keys[d, :v], before[0][d, :v], before[1][d, :v])
        assert torch.equal(after[0][d, :v], want[1]), f"worker {d}'s ids"
        assert torch.equal(after[1][d, :v], want[2]), f"worker {d}'s rows"
        # pads stay where they are
        assert torch.equal(after[0][d, v:], before[0][d, v:])
        assert torch.equal(after[1][d, v:], before[1][d, v:])


@pytest.mark.parametrize("length", [2, 32, 33, 512, 513, 1024, 1025, 2371,
                                    2372, 16384, 16385, 65536, 65537])
def test_a_run_at_a_class_edge_matches_the_reference(length):
    # worker 0: the run at its first slot, a run of 2 at its last valid
    # slot; worker 1: the run ending at its last valid slot, pads after
    rng = np.random.default_rng(length)
    m = length + 64
    w0 = _worker(rng, m, m, [length, 2])
    w1 = _worker(rng, m, m - 5, [3, length], tails=3)
    keys, before, after, valid, tied, overflow = _stage(
        [(*w0, m), (*w1, m - 5)])
    assert not bool(overflow)
    assert int(tied) == 2 * length + 5
    _check_against_reference(keys, before, after, valid)


@pytest.mark.parametrize("tails", [0, 2])
def test_a_run_over_a_whole_worker_matches_the_reference(tails):
    # every slot one key word: no pad, the run from the first slot to the
    # last; equal tails leave the order to the ids
    rng = np.random.default_rng(tails + 5)
    m = 1 << 12
    w = _worker(rng, m, m, [m], tails=tails)
    keys, before, after, valid, tied, overflow = _stage([(*w, m)] * 2)
    assert not bool(overflow) and int(tied) == 2 * m
    _check_against_reference(keys, before, after, valid)


def test_runs_on_both_sides_of_a_worker_boundary_stay_apart():
    # worker 0 ends in a run of the word worker 1 starts with: the stage
    # orders each worker's part alone, as the merge's split made them
    rng = np.random.default_rng(11)
    m = 256
    w0 = list(_worker(rng, m, m, [40, 7]))
    w1 = list(_worker(rng, m, 200, [9, 30]))
    w1[0][:200] += w0[0][m - 1] - w1[0][0]  # its first run has that word
    keys, before, after, valid, tied, overflow = _stage(
        [(*w0, m), (*w1, 200)])
    assert int(tied) == 40 + 7 + 9 + 30
    _check_against_reference(keys, before, after, valid)


@pytest.mark.parametrize("over", [False, True], ids=["fits", "overflows"])
def test_the_capacity_sets_overflow(over):
    rng = np.random.default_rng(3)
    m = 600
    w = _worker(rng, m, 590, [33, 100, 2])
    pairs = 32 + 99 + 1
    keys, before, after, valid, tied, overflow = _stage(
        [(*w, 590)], capacity=pairs - over)
    assert bool(overflow) == over
    if not over:
        _check_against_reference(keys, before, after, valid)


def test_the_cpu_takes_the_plain_version_and_launches_nothing(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(_build, "launch", no_launch)
    monkeypatch.setattr(key_tail, "order_key_tails", no_launch)
    rng = np.random.default_rng(8)
    w = _worker(rng, 128, 120, [5, 40])
    keys, before, after, valid, tied, overflow = _stage([(*w, 120)])
    want = (before[0].clone(), before[1].clone())
    ptied, pover = keytail.order_key_tails_plain(keys, *want, valid, None)
    assert torch.equal(after[0], want[0]) and torch.equal(after[1], want[1])
    assert int(tied) == int(ptied) == 45 and not bool(overflow)


def _good(m=64, pw=PW):
    keys = torch.zeros((2, m), dtype=torch.int32)
    return (keys, keys.clone(), torch.zeros((2, m, pw), dtype=torch.int32),
            torch.full((2,), m, dtype=torch.int32))


def _bad_inputs():
    k, i, r, v = _good()
    yield "keys_int64", (k.long(), i, r, v), TypeError
    yield "ids_shape", (k, i[:, :-1], r, v), ValueError
    yield "keys_1d", (k[0], i[0], r[0], v[:1]), ValueError
    yield "rows_2d", (k, i, r[..., 0], v), ValueError
    yield "rows_rows", (k, i, r[:, :-1], v), ValueError
    yield "pw_1", _good(pw=1), ValueError
    yield "valid_shape", (k, i, r, v[:1]), ValueError
    yield "valid_int64", (k, i, r, v.long()), TypeError
    yield "strided", (k[:, ::2], i[:, ::2], r[:, ::2], v), ValueError
    yield "two_devices", (k, i, r.to("meta"), v), ValueError


@pytest.mark.parametrize("name,args,error", list(_bad_inputs()),
                         ids=[b[0] for b in _bad_inputs()])
def test_bad_inputs_raise_before_any_launch(name, args, error, monkeypatch):
    def no_launch(*a, **kw):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(_build, "launch", no_launch)
    with pytest.raises(error):
        keytail.order_key_tails(*args, None)


def test_the_kernel_wrapper_refuses_cpu_tensors_and_wider_rows(monkeypatch):
    monkeypatch.setattr(_build, "launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        key_tail.order_key_tails(*_good(), 10)

    # the C side's sizes refuse a pw past its limit (out[4]); the wrapper
    # raises that as a ValueError
    def sizes(slots, pw, capacity, out):
        out[0], out[4] = 16, 111
        return 0 if 2 <= pw <= 111 else 1
    monkeypatch.setattr(_build, "function", lambda name: sizes)
    assert key_tail.sizes(1 << 10, 111, None)[0] == 16
    with pytest.raises(ValueError, match="2 to 111 payload words"):
        key_tail.sizes(1 << 10, 112, None)
    # the plain version has no such limit
    tied, overflow = keytail.order_key_tails(*_good(pw=112), None)
    assert int(tied) == 2 * 64 and not bool(overflow)


def test_the_card_path_counts_the_moved_records(monkeypatch):
    # off the CPU the stage calls the kernel's wrapper and adds the
    # records it moved to the device count key_tail.moved
    from repro_torch.obs import device

    # a fresh object, as a traced benchmark run installs one: the stage
    # adds to the one the module holds at the call
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    seen = []

    def kernel(keys, ids, rows, valid, capacity):
        seen.append(capacity)
        return (torch.tensor(7), torch.tensor(False), torch.tensor(5))
    monkeypatch.setattr(key_tail, "order_key_tails", kernel)
    args = [t.to("meta") for t in _good()]
    for capacity in (None, 9):
        tied, overflow = keytail.order_key_tails(*args, capacity)
        assert int(tied) == 7 and not bool(overflow)
    assert seen == [None, 9]
    assert device.device_counts.value("key_tail.moved") == 10
