"""The `indy10.resident` cell's pieces on the CPU: the 10-byte key's
generator, the reference's check against each fault a wide-key sort can
have, the control, the refusal of a program that sorts 4 key bytes, and
the key-tail metrics.

Uniform 32-bit key words at a size the CPU sorts quickly hold almost no
equal pairs, so where a test needs runs of equal key words it keeps the
top 16 bits of each word (`narrow_keys`): the program, the reference
and the control all read the key words from `key10.key_parts_t`.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from perfbench import controls_key10
from perfbench import run as bench_run
from perfbench.lib import spec
from perfbench.lib.devtrace import DeviceTrace, Op
from perfbench.reference import gen, key10

CELL = "indy10.resident"
SEED = 2**33 + 17


def shrink(cell):
    return dataclasses.replace(
        cell, traffic=dict(cell.traffic, warmup_calls=1, trace_calls=2),
        config=dict(cell.config, records=1 << 13))


@pytest.fixture
def narrow_keys(monkeypatch):
    parts = key10.key_parts_t

    def narrow(ids, seed, shape="uniform"):
        word, w0, lo = parts(ids, seed, shape)
        return word & 0xFFFF0000, w0, lo

    monkeypatch.setattr(key10, "key_parts_t", narrow)


@pytest.fixture
def fresh_counters(monkeypatch):
    from repro_torch.obs import device
    from repro_torch.obs.metrics import MetricsRegistry

    monkeypatch.setattr(device, "counters", MetricsRegistry())
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    return device.counters


def run_small(*, seed=SEED, trace=0, wrap=None):
    rc, line = bench_run.main(
        ["--workload", CELL, "--seed", str(seed), "--seconds", "0.2",
         "--trace", str(trace)], device="cpu", adjust=shrink, wrap=wrap,
        guard_modules=False)
    assert rc == 0
    return line


@pytest.mark.parametrize("seed", [0, 2**31 + 13, 2**40 + 7])
def test_torch_and_numpy_make_the_same_records(seed):
    ids = np.concatenate([np.arange(300), [2**31 - 1, 2**31, 2**32 - 1]])
    k, i, p = key10.records_t(0, 300, seed, "uniform", "cpu")
    word, _, _ = key10.key_parts_np(ids, seed)
    np.testing.assert_array_equal(gen.widen(k).numpy(), word[:300])
    np.testing.assert_array_equal(gen.widen(i).numpy(), ids[:300])
    parts = key10.key_parts_t(torch.as_tensor(ids, dtype=torch.int64), seed)
    for got, want in zip(parts, key10.key_parts_np(ids, seed)):
        np.testing.assert_array_equal(got.numpy(), want)
    rows = key10.payload_t(torch.as_tensor(ids, dtype=torch.int64), seed)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  key10.payload_np(ids, seed))
    np.testing.assert_array_equal(p.numpy(), rows[:300].numpy())
    # the value words are gen's; the key's bytes 4-9 are not constant
    base = gen.payload_np(ids, seed)
    got = key10.payload_np(ids, seed)
    np.testing.assert_array_equal(got[:, 2:], base[:, 2:])
    np.testing.assert_array_equal(got[:, 1] & 0xFFFF, base[:, 1] & 0xFFFF)
    assert len(np.unique(got[:, 0])) > 290
    assert len(np.unique(got[:, 1] >> 16)) > 250


def test_splitmix_matches_its_published_outputs(monkeypatch):
    # SplitMix64 from state 0: its first three outputs, as the reference
    # C code (Vigna, splitmix64.c) gives them
    want = [0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, 0x06C45D188009454F]
    monkeypatch.setattr(key10, "seed_state", lambda seed: (0, 0))
    word, w0, _ = key10.key_parts_t(torch.arange(3, dtype=torch.int64), 1)
    assert [(int(a) << 32) | int(b) for a, b in zip(word, w0)] == want
    word, w0, _ = key10.key_parts_np(np.arange(3), 1)
    assert [(int(a) << 32) | int(b) for a, b in zip(word, w0)] == want


# gen.keys_t's key word at this seed repeats under id ^ 2596: every
# record of ids [0, 2^12) shares its word with another
PAIRED_SEED = 2147672760


@pytest.mark.parametrize("seed", [PAIRED_SEED, 0, 2**31 + 13, SEED])
def test_key_words_repeat_as_random_words_do(seed):
    n = 1 << 13
    ids = np.arange(n)
    if seed == PAIRED_SEED:
        assert len(np.unique(gen.keys_np(ids, seed, "uniform"))) == n // 2
    word, _, _ = key10.key_parts_np(ids, seed)
    # n^2 / 2^17 = 512 equal pairs of the top 16 bits expected (sd ~23)
    _, counts = np.unique(word >> 16, return_counts=True)
    pairs = int((counts * (counts - 1) // 2).sum())
    assert 400 < pairs < 624
    assert len(np.unique(word)) >= n - 2


def test_the_reference_orders_by_all_ten_bytes():
    n, seed = 1 << 12, 5
    sk, si = key10.lex_order(n, seed, "uniform", "cpu")
    tail = key10.tail48_t(si, seed)
    assert torch.equal(torch.sort(si).values, torch.arange(n))
    same = sk[1:] == sk[:-1]
    assert bool((sk[1:] >= sk[:-1]).all())
    assert bool(((tail[1:] > tail[:-1]) | ((tail[1:] == tail[:-1])
                                           & (si[1:] > si[:-1])))[same].all())


def test_the_program_is_correct_with_runs_of_equal_key_words(narrow_keys,
                                                             fresh_counters):
    line = run_small(trace=1)
    assert line["correct"] is True
    share = line["metrics"]["key_tail_records_share"]["value"]
    # 2^13 records over 2^16 key words: 1 - e^(-1/8) of them, 11.8%
    assert 8.0 < share < 16.0


def four_byte_order(entry):
    def sort(*args, **kw):
        return entry(*args, **dict(kw, key_bytes=4))
    return sort


def payload_altered(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        pout = pout.clone()
        pout[0, 1] ^= 1 << 20  # a bit of key byte 9
        return mk, mv, pout, valid, ovf
    return sort


def record_left_out(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        return mk, mv, pout, valid - torch.eye(len(valid),
                                               dtype=valid.dtype)[0], ovf
    return sort


def writes_its_input(entry):
    def sort(keys, ids, payload, **kw):
        out = entry(keys, ids, payload, **kw)
        payload[1, 0] += 1
        return out
    return sort


@pytest.mark.parametrize("wrap,check", [
    (four_byte_order, "mismatched_records"),
    (payload_altered, "mismatched_records"),
    (record_left_out, "mismatched_records"),
    (writes_its_input, "input_changed_records")])
def test_each_fault_is_not_correct(wrap, check, narrow_keys):
    line = run_small(wrap=wrap)
    assert line["correct"] is False
    assert line["check"][check]["value"] > 0


@pytest.mark.parametrize("seed", [11, 2**31 + 13, SEED])
def test_the_control_is_not_correct(seed, narrow_keys):
    out = controls_key10.run_control(shrink(spec.load_cell(CELL)), seed,
                                     device="cpu")
    assert not out.correct
    bad = out.checks[0]
    assert bad.name == "mismatched_records" and bad.value > 100


def test_a_program_without_key_bytes_is_refused(monkeypatch):
    from repro_torch.core import exoshuffle

    def four_bytes(keys, ids, payload, *, num_workers, mode="through",
                   device="cuda"):
        raise AssertionError("never called")

    monkeypatch.setattr(exoshuffle, "distributed_sort_payload", four_bytes)
    with pytest.raises(RuntimeError, match="4 of the 10 key bytes"):
        run_small()


def _ctx(trace, calls):
    return types.SimpleNamespace(trace=trace, trace_calls=calls)


def test_key_tail_ms_reads_its_span_per_call():
    ops = [Op("sort", 0.0, 0.002, 0.0005),
           Op("tail", 0.003, 0.0034, 0.0025),
           Op("tail", 0.0034, 0.0035, 0.0026),
           Op("next", 0.005, 0.006, 0.0041)]
    ranges = [("sort.merge", 0.0, 0.002), ("sort.key_tail", 0.0024, 0.004)]
    read = spec.metric_reader("key_tail_ms_per_sort")
    got = read(_ctx(DeviceTrace(ops, ranges, 0.0, 0.006), 2))
    assert got == pytest.approx(0.25)
    assert read(_ctx(DeviceTrace(ops, ranges[:1], 0.0, 0.006), 2)) is None
    assert read(_ctx(None, 0)) is None


def test_key_tail_share_reads_the_counters(fresh_counters):
    from repro_torch.core import exoshuffle

    read = spec.metric_reader("key_tail_records_share")
    trace = DeviceTrace([], [], 0.0, 1.0)
    n, w = 1 << 12, 4
    keys, ids, payload = key10.records_t(0, n, 3, "uniform", "cpu")
    keys = keys & -(1 << 22)  # 1,024 key words: runs in every worker
    exoshuffle.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                        device="cpu")
    assert read(_ctx(trace, 1)) is None  # the 4-byte path counts no ties
    mk, _, _, valid, _ = exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, device="cpu", key_bytes=10)
    tied = 0
    for d, seg in enumerate(mk.view(w, -1)):
        _, counts = np.unique(seg[:int(valid[d])].numpy(),
                              return_counts=True)
        tied += int(counts[counts > 1].sum())
    assert tied > 0
    assert read(_ctx(trace, 1)) == pytest.approx(100.0 * tied / (2 * n))
    assert read(_ctx(None, 0)) is None
