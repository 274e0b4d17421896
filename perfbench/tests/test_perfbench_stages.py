"""The per-stage readers: device time launched inside the port's spans
(lib/stages.py) on synthetic traces, and the exchange's slot fill from
the port's counters after a tiny CPU sort."""
import types

import numpy as np
import pytest

from perfbench.lib import spec, stages
from perfbench.lib.devtrace import DeviceTrace, Op

# metric: the spans it reads
STAGES = {
    "map_sort_ms_per_sort": ("sort.map",),
    "block_pack_ms_per_sort": ("sort.partition", "sort.pack"),
    "exchange_ms_per_sort": ("sort.exchange", "payload.exchange"),
    "merge_ms_per_sort": ("sort.merge",),
    "id_join_ms_per_sort": ("payload.join",),
}
ORDER = ["sort.map", "sort.partition", "sort.pack", "sort.exchange",
         "payload.pack", "payload.exchange", "sort.merge", "payload.join",
         "sort.overflow_check"]


def _sorts(calls=2):
    """`calls` sorts of 10 ms each: span i of ORDER opens at 1 ms + i ms
    of the call and launches one op of (i + 1) µs; one op is launched
    outside every stage, one has no launch time."""
    ops, ranges = [], []
    for c in range(calls):
        t = 0.010 * c
        ranges.append(("perfbench.call", t, t + 0.010))
        ranges.append(("exoshuffle.call", t + 0.0005, t + 0.0099))
        for i, name in enumerate(ORDER):
            a = t + 0.001 * (i + 1)
            ranges.append((name, a, a + 0.0008))
            ops.append(Op(f"k{i}", a + 0.0002, a + 0.0002 + 1e-6 * (i + 1),
                          a + 0.0001))
        ops.append(Op("outside", t + 0.0006, t + 0.0007, t + 0.0005))
        ops.append(Op("unlaunched", t + 0.0095, t + 0.0096, None))
    return DeviceTrace(ops, ranges, 0.0, 0.010 * calls)


def _ctx(trace, calls=2):
    return types.SimpleNamespace(trace=trace, trace_calls=calls)


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_each_stage_sums_only_its_spans_per_call(metric):
    want_us = sum(ORDER.index(name) + 1 for name in STAGES[metric])
    got = spec.metric_reader(metric)(_ctx(_sorts(2), 2))
    assert got == pytest.approx(want_us / 1e3, rel=1e-9)
    # twice the calls in the trace, twice the calls to divide by
    assert spec.metric_reader(metric)(_ctx(_sorts(4), 4)) == \
        pytest.approx(got, rel=1e-9)


def test_the_stages_cover_every_launched_op_but_the_overflow_check():
    # `payload.pack` (a rank mesh's row pack) is read by no stage metric:
    # it counts with the overflow check
    t = _sorts(2)
    total = sum(spec.metric_reader(m)(_ctx(t)) for m in STAGES)
    unread = stages.ms_per_call(_ctx(t), "sort.overflow_check",
                                "payload.pack")
    assert total + unread == pytest.approx(
        1e3 * sum(o.end - o.start for o in t.ops if o.name.startswith("k"))
        / 2, rel=1e-9)


def test_two_spans_that_overlap_count_an_op_once():
    ops = [Op("a", 0.0, 0.004, 0.0015), Op("b", 0.004, 0.005, 0.0025),
           Op("c", 0.005, 0.006, 0.0045)]
    ranges = [("sort.exchange", 0.001, 0.003),
              ("payload.exchange", 0.002, 0.004)]
    t = DeviceTrace(ops, ranges, 0.0, 0.006)
    read = spec.metric_reader("exchange_ms_per_sort")
    assert read(_ctx(t, 1)) == pytest.approx(5.0)
    assert stages.seconds_in(t, {"sort.exchange"}) + stages.seconds_in(
        t, {"payload.exchange"}) == pytest.approx(0.006)


def test_names_match_whole_not_by_prefix():
    ops = [Op("a", 0.0, 0.001, 0.0005)]
    t = DeviceTrace(ops, [("sort.mapper", 0.0, 0.001)], 0.0, 0.001)
    assert stages.seconds_in(t, {"sort.map"}) == 0.0
    assert stages.seconds_in(t, {"sort.mapper"}) == pytest.approx(0.001)


@pytest.mark.parametrize("metric", sorted(STAGES) + ["exchange_slot_fill"])
def test_readers_give_nothing_without_a_trace_or_spans(metric):
    read = spec.metric_reader(metric)
    assert read(types.SimpleNamespace()) is None
    assert read(types.SimpleNamespace(trace=None, trace_calls=5)) is None
    if metric in STAGES:
        # a trace of a program that opens no such spans: the benchmark's
        # own ranges only
        ops = [Op("gather", 0.0, 0.001, 0.0002)]
        ranges = [("perfbench.call", 0.0, 0.002),
                  ("perfbench.payload.take_rows", 0.0001, 0.0003)]
        t = DeviceTrace(ops, ranges, 0.0, 0.002)
        assert read(_ctx(t, 1)) is None


@pytest.fixture
def fresh_counters(monkeypatch):
    from repro_torch.obs import device
    from repro_torch.obs.metrics import MetricsRegistry

    monkeypatch.setattr(device, "counters", MetricsRegistry())
    return device.counters


def test_slot_fill_reads_half_where_capacity_rounds_to_twice_the_mean(
        fresh_counters):
    from repro_torch.core import exoshuffle

    w, n = 4, 1 << 12  # 1,024 records a worker, mean block 256, C = 512
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    ids = np.arange(n, dtype=np.uint32)
    payload = rng.integers(0, 2**32, (n, 3), dtype=np.uint32)
    exoshuffle.distributed_sort_payload(keys, ids, payload, num_workers=w,
                                        device="cpu")
    assert fresh_counters.counter_value("exchange.slots") == w * w * 512
    read = spec.metric_reader("exchange_slot_fill")
    assert read(_ctx(DeviceTrace([], [], 0.0, 1.0))) == 50.0
    assert read(_ctx(None)) is None


def test_slot_fill_without_any_exchange_is_nothing(fresh_counters):
    read = spec.metric_reader("exchange_slot_fill")
    assert read(_ctx(DeviceTrace([], [], 0.0, 1.0))) is None


def test_a_small_traced_run_reports_the_slot_fill(small_run, fresh_counters):
    # 2^12 records over W = 8: a mean block of 64, C = 128
    line = small_run("indy.resident", trace=1)
    assert line["metrics"]["exchange_slot_fill"] == {"value": 50.0,
                                                     "unit": "%"}
