"""The `daytona10.resident` cell's pieces on the CPU: the skewed 10-byte
key's generator, the cell at a small size, the reference's check
against each fault a Daytona sort can have, the refusal of a program
that cannot sample its splitters, and the two metrics of the cell.

The cell's 2^-10 sample holds 65,536 keys at its 2^26 records; at the
2^13 records the CPU sorts quickly that would be 8, too few to split
by, so the small cell samples 2^-4 of its keys (512).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from perfbench import controls_skew10
from perfbench import run as bench_run
from perfbench.lib import spec
from perfbench.lib.devtrace import DeviceTrace, Op
from perfbench.reference import gen, key10, skew10

CELL = "daytona10.resident"
SEED = 2**33 + 17


def shrink(cell):
    return dataclasses.replace(
        cell, traffic=dict(cell.traffic, warmup_calls=1, trace_calls=2),
        config=dict(cell.config, records=1 << 13))


@pytest.fixture
def fresh_counters(monkeypatch):
    from repro_torch.obs import device
    from repro_torch.obs.metrics import MetricsRegistry

    monkeypatch.setattr(device, "counters", MetricsRegistry())
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    return device


def run_small(*, seed=SEED, trace=0, wrap=None, adjust=shrink):
    rc, line = bench_run.main(
        ["--workload", CELL, "--seed", str(seed), "--seconds", "0.2",
         "--trace", str(trace)], device="cpu", adjust=adjust, wrap=wrap,
        guard_modules=False)
    assert rc == 0
    return line


@pytest.mark.parametrize("seed", [0, 2**31 + 13, 2**40 + 7])
def test_torch_and_numpy_make_the_same_records(seed):
    ids = np.concatenate([np.arange(300), [2**31 - 1, 2**31, 2**32 - 1]])
    k, i, p = skew10.records_t(0, 300, seed, "cpu")
    word, _, _ = skew10.key_parts_np(ids, seed)
    np.testing.assert_array_equal(gen.widen(k).numpy(), word[:300])
    np.testing.assert_array_equal(gen.widen(i).numpy(), ids[:300])
    parts = skew10.key_parts_t(torch.as_tensor(ids, dtype=torch.int64), seed)
    for got, want in zip(parts, skew10.key_parts_np(ids, seed)):
        np.testing.assert_array_equal(got.numpy(), want)
    rows = skew10.payload_t(torch.as_tensor(ids, dtype=torch.int64), seed)
    np.testing.assert_array_equal(rows.numpy().view(np.uint32),
                                  skew10.payload_np(ids, seed))
    np.testing.assert_array_equal(p.numpy(), rows[:300].numpy())
    # the value words are gen's
    got, base = skew10.payload_np(ids, seed), gen.payload_np(ids, seed)
    np.testing.assert_array_equal(got[:, 2:], base[:, 2:])
    np.testing.assert_array_equal(got[:, 1] & 0xFFFF, base[:, 1] & 0xFFFF)


@pytest.mark.parametrize("seed", [5, 2**31 + 13])
def test_the_key_is_key10s_80_bits_shifted_right(seed):
    ids = np.arange(2000)
    hi, lo, tail = key10.key_parts_np(ids, seed)
    word, w0, t = skew10.key_parts_np(ids, seed)
    s = skew10.shifts_t(torch.as_tensor(ids), seed).tolist()
    assert set(s) == set(range(skew10.SHIFTS))
    for j in range(len(ids)):
        k = ((int(hi[j]) << 48) | (int(lo[j]) << 16) | int(tail[j])) >> s[j]
        assert (int(word[j]), int(w0[j]), int(t[j])) == \
            (k >> 48, (k >> 16) & gen.MASK, k & 0xFFFF)


def test_the_skew_ties_most_records_and_breaks_the_equal_split():
    word, _, _ = skew10.key_parts_np(np.arange(1 << 18), 3)
    srt = np.sort(word)
    eq = srt[1:] == srt[:-1]
    tied = np.zeros(srt.shape, bool)
    tied[1:] |= eq
    tied[:-1] |= eq
    assert 0.25 < tied.mean() < 0.7  # 65.6% at 2^26 records
    assert 0.88 < (word < 1 << 29).mean() < 0.94  # 91% at worker 0


def test_the_reference_orders_the_whole_key():
    n, seed = 1 << 12, 5
    sk, si = skew10.lex_order(n, seed, "cpu")
    tail = skew10.tail48_t(si, seed)
    assert torch.equal(torch.sort(si).values, torch.arange(n))
    same = sk[1:] == sk[:-1]
    assert int(same.sum()) > n // 64  # 143 at this seed
    assert bool((sk[1:] >= sk[:-1]).all())
    assert bool(((tail[1:] > tail[:-1]) | ((tail[1:] == tail[:-1])
                                           & (si[1:] > si[:-1])))[same].all())


def test_the_cell_at_2_to_the_13_records_is_correct(fresh_counters):
    line = run_small(trace=1)
    assert line["correct"] is True
    assert all(c["value"] == 0 for c in line["check"].values())
    metrics = line["metrics"]
    assert 5.0 < metrics["key_tail_records_share"]["value"] < 60.0
    assert 100.0 <= metrics["worker_load_peak"]["value"] < 110.0
    assert metrics["exchange_slot_fill"]["value"] == 50.0
    # the counts cover the two traced calls alone
    assert fresh_counters.counters.counter_value("exchange.records") == \
        2 * (1 << 13)
    # the configuration's own sample: 2^-10 of 2^13 records would leave
    # a worker one key, so each gives MIN_SAMPLES (64)
    cell = spec.load_cell(CELL)
    assert cell.config["sample_fraction"] == 2**-10
    assert cell.traffic["driver"] == "resident_skew10"


def four_byte_order(entry):
    def sort(*args, **kw):
        return entry(*args, **dict(kw, key_bytes=4))
    return sort


def equal_split(entry):
    def sort(*args, **kw):
        return entry(*args, **dict(kw, sample_fraction=0.0))
    return sort


def payload_altered(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        pout = pout.clone()
        pout[0, 5] ^= 1  # a value bit
        return mk, mv, pout, valid, ovf
    return sort


def record_left_out(entry):
    def sort(*args, **kw):
        mk, mv, pout, valid, ovf = entry(*args, **kw)
        return mk, mv, pout, valid - torch.eye(len(valid),
                                               dtype=valid.dtype)[-1], ovf
    return sort


def writes_its_input(entry):
    def sort(keys, ids, payload, **kw):
        out = entry(keys, ids, payload, **kw)
        payload[1, 0] += 1
        return out
    return sort


@pytest.mark.parametrize("wrap,check", [
    (four_byte_order, "mismatched_records"),
    (equal_split, "overflow"),
    (payload_altered, "mismatched_records"),
    (record_left_out, "mismatched_records"),
    (writes_its_input, "input_changed_records")])
def test_each_fault_is_not_correct(wrap, check):
    line = run_small(wrap=wrap)
    assert line["correct"] is False
    assert line["check"][check]["value"] > 0


@pytest.mark.parametrize("seed", [11, 2**31 + 13])
def test_the_control_is_not_correct(seed):
    # the 4-byte order in W full segments (perfbench/controls_skew10.py)
    out = controls_skew10.run_control(shrink(spec.load_cell(CELL)), seed,
                                      device="cpu")
    assert not out.correct
    bad, changed, overflow = out.checks
    assert bad.name == "mismatched_records" and bad.value > 100
    assert changed.value == 0 and overflow.value == 0


def test_the_control_differs_only_in_the_key_tail(monkeypatch):
    # with key bytes 4-9 all zero the 4-byte order is the rules' order,
    # and the control is correct: its layout, ids and payload are right
    parts = skew10.key_parts_t

    def no_tail(ids, seed):
        word, _, _ = parts(ids, seed)
        return word, torch.zeros_like(word), torch.zeros_like(word)

    monkeypatch.setattr(skew10, "key_parts_t", no_tail)
    out = controls_skew10.run_control(shrink(spec.load_cell(CELL)), 5,
                                      device="cpu")
    assert out.correct, [(c.name, c.value) for c in out.checks]


def test_a_program_without_sample_fraction_is_refused(monkeypatch):
    from repro_torch.core import exoshuffle

    def no_sampling(keys, ids, payload, *, num_workers, mode="through",
                    device="cuda", key_bytes=4):
        raise AssertionError("never called")

    monkeypatch.setattr(exoshuffle, "distributed_sort_payload", no_sampling)
    with pytest.raises(TypeError, match="sample_fraction"):
        run_small()


def _ctx(trace, calls, workers=0):
    return types.SimpleNamespace(trace=trace, trace_calls=calls,
                                 workers=workers)


def test_sample_ms_reads_its_span_per_call():
    ops = [Op("sort", 0.0, 0.002, 0.0005),
           Op("sample", 0.003, 0.0034, 0.0025),
           Op("sample", 0.0034, 0.0035, 0.0026),
           Op("part", 0.005, 0.006, 0.0041)]
    ranges = [("sort.map", 0.0, 0.002), ("sort.sample", 0.0024, 0.004)]
    read = spec.metric_reader("sample_ms_per_sort")
    got = read(_ctx(DeviceTrace(ops, ranges, 0.0, 0.006), 2))
    assert got == pytest.approx(0.25)
    assert read(_ctx(DeviceTrace(ops, ranges[:1], 0.0, 0.006), 2)) is None
    assert read(_ctx(None, 0)) is None


def test_worker_load_peak_reads_the_count(fresh_counters, monkeypatch):
    from repro_torch.core import exoshuffle
    from repro_torch.obs.metrics import MetricsRegistry

    read = spec.metric_reader("worker_load_peak")
    trace = DeviceTrace([], [], 0.0, 1.0)
    n, w = 1 << 12, 4
    keys, ids, payload = skew10.records_t(0, n, 3, "cpu")
    exoshuffle.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                        device="cpu", key_bytes=10)
    assert read(_ctx(trace, 1, w)) is None  # the equal split counts none
    monkeypatch.setattr(fresh_counters, "counters", MetricsRegistry())
    peaks = [int(exoshuffle.distributed_sort_payload(
        keys, ids, payload, num_workers=w, device="cpu", key_bytes=10,
        sample_fraction=2**-4)[3].max()) for _ in range(2)]
    # two calls sent 2n records, so a worker's mean is 2n / w
    got = read(_ctx(trace, 1, w))
    assert got == pytest.approx(100.0 * sum(peaks) * w / (2 * n))
    assert 100.0 <= got < 110.0
    assert read(_ctx(None, 0, w)) is None
    assert read(_ctx(trace, 1)) is None
