"""The device sort's spans and counters (obs/device.py), on the CPU.

Under a torch profiler `distributed_sort` and `distributed_sort_payload`
open one range a stage, in order, each inside `exoshuffle.call`; the
benchmark's trace reader (perfbench/lib/devtrace.capture) finds them on
its clock inside the caller's range. With no profiler the sort enters
no `record_function`. The exchange counters advance by the records and
the slots the held workers send, and the profiler changes no output.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import exoshuffle
from repro_torch.obs import device
from repro_torch.obs.metrics import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.lib import devtrace  # noqa: E402

torch.set_num_threads(2)

W, N, PW = 4, 1 << 12, 3
HEADER_SPANS = ["exoshuffle.call", "sort.map", "sort.partition",
                "sort.pack", "sort.exchange", "sort.merge",
                "sort.overflow_check"]
# Without a mesh the through mode gathers each row from its producer
# inside `payload.join`: `payload.pack` and `payload.exchange` open only
# on a rank mesh (tests/test_torch_through_rows.py), and must not here.
PAYLOAD_SPANS = ["exoshuffle.call", "sort.map", "sort.partition",
                 "sort.pack", "sort.exchange", "payload.join", "sort.merge",
                 "payload.join", "sort.overflow_check"]
WIDE_SPANS = PAYLOAD_SPANS[:-1] + ["sort.key_tail", "sort.overflow_check"]
ALL_SPANS = set(WIDE_SPANS) | {"payload.pack", "payload.exchange"}

# entry ("headers": distributed_sort; else distributed_sort_payload in
# that mode, ".key10": with key_bytes=10): the spans it opens, in order
ENTRIES = {"through": PAYLOAD_SPANS, "late": HEADER_SPANS,
           "headers": HEADER_SPANS, "through.key10": WIDE_SPANS}


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = np.arange(n, dtype=np.uint32)
    payload = rng.integers(0, 2**32, (n, PW), dtype=np.uint32)
    return keys, ids, payload


def _sort(entry, w=W, n=N, capacity_factor=1.5):
    keys, ids, payload = _records(n)
    kw = dict(num_workers=w, device="cpu", capacity_factor=capacity_factor)
    if entry == "headers":
        return exoshuffle.distributed_sort(keys, ids, **kw)
    mode, _, wide = entry.partition(".")
    return exoshuffle.distributed_sort_payload(
        keys, ids, payload, mode=mode, key_bytes=10 if wide else 4, **kw)


def _program_ranges(prof):
    """(name, start_ns, end_ns) of the program's spans, by start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name() in ALL_SPANS]
    return sorted(out, key=lambda r: r[1])


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_spans_open_in_order_inside_the_call(entry):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _sort(entry)
    ranges = _program_ranges(prof)
    assert [r[0] for r in ranges] == ENTRIES[entry]
    _, call_start, call_end = ranges[0]
    for (_, s, e), (_, s_next, _) in zip(ranges[1:], ranges[2:] + [
            (None, call_end, None)]):
        assert call_start <= s <= e <= s_next <= call_end


def test_spans_lie_in_the_callers_range_on_the_trace_clock():
    def traced():
        with torch.profiler.record_function("perfbench.call"):
            _sort("through")

    _, trace = devtrace.capture(traced)
    (call,) = [r for r in trace.ranges if r[0] == "perfbench.call"]
    spans = [r for r in trace.ranges if r[0] in ALL_SPANS]
    assert sorted(r[0] for r in spans) == sorted(PAYLOAD_SPANS)
    assert trace.start <= call[1] <= call[2] <= trace.end
    for name, s, e in spans:
        assert call[1] <= s <= e <= call[2], name


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_record_function_without_a_profiler(entry, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    _sort(entry)


# (W, records in all, capacity factor, the block capacity C)
SIZES = [(4, 1 << 12, 1.5, 512), (8, 1 << 12, 2.0, 128),
         (2, 1 << 10, 1.0, 256)]


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"w{s[0]}_n{s[1]}")
def test_exchange_counters_advance_per_call(entry, size, monkeypatch):
    w, total, factor, capacity = size
    n = total // w  # records a worker holds
    assert exoshuffle.ShuffleConfig(
        num_workers=w, capacity_factor=factor).block_capacity(n) == capacity
    monkeypatch.setattr(device, "counters", MetricsRegistry())
    for calls in (1, 2):
        _sort(entry, w=w, n=total, capacity_factor=factor)
        assert device.counters.counter_value("exchange.records") == \
            calls * w * n
        assert device.counters.counter_value("exchange.slots") == \
            calls * w * w * capacity


def test_key_tail_counter_counts_the_records_in_runs(monkeypatch):
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())
    keys, ids, payload = _records(N)
    keys[1::3] = keys[0::3][:len(keys[1::3])]  # runs of equal key words
    want = 0
    for calls in (1, 2):
        mk, _, _, valid, _ = exoshuffle.distributed_sort_payload(
            keys, ids, payload, num_workers=W, device="cpu", key_bytes=10)
        seg = mk.numpy().reshape(W, -1)
        for d in range(W):
            _, counts = np.unique(seg[d, :int(valid[d])], return_counts=True)
            want += int(counts[counts > 1].sum())
        assert want > calls * N // 2
        assert device.device_counts.value("key_tail.records") == want
    assert "key_tail.records" not in device.counters.snapshot()["counters"]


def test_device_counts_add_on_the_device_and_read_as_ints():
    counts = device.DeviceCounts()
    assert counts.value("x") is None
    one = torch.tensor(3, dtype=torch.int64)
    counts.add("x", one)
    one += 1  # the total holds its own copy
    counts.add("x", torch.tensor(5, dtype=torch.int64))
    assert counts.value("x") == 8 and isinstance(counts.value("x"), int)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_profiler_changes_no_output(entry):
    plain = _sort(entry)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _sort(entry)
    assert len(plain) == len(traced)
    assert plain[-1] is traced[-1]  # the overflow flag, a bool
    for a, b in zip(plain[:-1], traced[:-1]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_obs_package_stays_free_of_torch():
    code = ("import sys, repro_torch.obs; "
            "print('torch' in sys.modules, "
            "'repro_torch.obs.device' in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["False", "False"]
