"""The arithmetic behind the metrics: rates over the whole window,
rooflines from shapes, trace reduction."""
import types

import pytest

from perfbench.lib import devtrace, roofline, spec
from perfbench.lib.devtrace import DeviceTrace, Op

PEAK = spec.peaks()["NVIDIA H100 80GB HBM3"]


def test_the_peak_table_is_the_data_sheet():
    assert PEAK["hbm_bytes_per_s"] == 3.35e12


def test_rate_is_all_records_over_the_whole_window(small_cell):
    cell = small_cell("indy.resident")
    out = spec.driver(cell.traffic).run(cell, seed=5, seconds=0.3,
                                        trace=False, t0=0.0, device="cpu")
    n, calls = out.notes["records"], out.notes["calls"]
    assert out.notes["window_s"] >= 0.3
    assert out.end_to_end["resident_sort_records_per_s"] == pytest.approx(
        calls * n / out.notes["window_s"], rel=1e-12)
    assert out.attempted == calls


def _trace():
    ops = [Op("bitonic_tile", 0.0, 0.010, 0.0),
           Op("bitonic_global<4>", 0.010, 0.012, 0.001),
           Op("index_select", 0.015, 0.020, 0.013),
           Op("kway_rank_scatter<4>", 0.030, 0.031, 0.0295)]
    ranges = [("perfbench.payload.take_rows", 0.0125, 0.0135),
              ("perfbench.call", 0.0, 0.040)]
    return DeviceTrace(ops, ranges, 0.0, 0.040)


def test_trace_busy_idle_and_attribution():
    t = _trace()
    assert t.busy_s() == pytest.approx(0.018)
    assert devtrace.idle_share(t) == pytest.approx(55.0)
    assert t.seconds("bitonic_") == pytest.approx(0.012)
    assert t.seconds_launched_in("perfbench.payload.") == pytest.approx(0.005)
    gaps = t.idle_gaps([("perfbench.call", 0.0, 0.040),
                        ("map.encode", 0.020, 0.030)], 2)
    assert [g[0] for g in gaps] == ["map.encode", "perfbench.call"]
    assert gaps[0][1] == pytest.approx(0.010)
    assert t.top_ops(1) == [["bitonic_tile", pytest.approx(0.010)]]


def test_readers_compute_rooflines_from_shapes():
    t = _trace()
    ctx = types.SimpleNamespace(
        peaks=PEAK, trace=t, trace_calls=2, records_per_call=1 << 26,
        launches=[("bitonic_sort_blocks", "launches", 1, (8, 1 << 22)),
                  ("bitonic_sort_blocks", "launches", 2, (8, 1 << 21)),
                  ("merge_sorted_pairs", "launches", 7, (32, 1 << 18))])
    read = spec.metric_reader
    assert read("bitonic_sort_roofline")(ctx) == pytest.approx(
        100 * 16 * (1 << 26) / 3.35e12 / 0.012)
    assert read("resident_sort_roofline")(ctx) == pytest.approx(
        100 * 200 * (1 << 26) * 2 / 3.35e12 / 0.018)
    assert read("device_idle_share.resident")(ctx) == pytest.approx(55.0)


def test_the_whole_sort_roofline_is_device_time_not_host_time():
    """Idle host time between the traced calls leaves the share alone;
    more device time lowers it."""
    base = _trace()
    idle = DeviceTrace(base.ops, base.ranges, -5.0, 5.0)
    slow = DeviceTrace(base.ops + [Op("gather", 0.032, 0.050, 0.031)],
                       base.ranges, 0.0, 0.050)
    read = spec.metric_reader("resident_sort_roofline")

    def ctx(t):
        return types.SimpleNamespace(peaks=PEAK, trace=t, trace_calls=2,
                                     records_per_call=1 << 20)

    assert read(ctx(idle)) == pytest.approx(read(ctx(base)), rel=1e-12)
    assert read(ctx(slow)) == pytest.approx(
        read(ctx(base)) * 0.018 / 0.036, rel=1e-12)


def test_readers_return_nothing_without_their_input():
    empty = types.SimpleNamespace()
    for m in spec._json(spec.ROOT / "BENCHMARK.json")["per_layer"]:
        assert spec.metric_reader(m["name"])(empty) is None, m["name"]


def test_least_bytes():
    assert roofline.whole_sort_bytes(10) == 2000
    assert roofline.bitonic_sort_bytes(8, 1024) == 8 * 1024 * 16
    assert roofline.share(0, 1.0, 1.0) is None
