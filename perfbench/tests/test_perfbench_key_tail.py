"""The key-tail kernel's roofline: the least bytes of each logged call,
4 V + 8 T + 8 pw X scaled from the program's counts, over the device
time of the kernels named key_tail*."""
import types

import pytest
import torch

from perfbench.lib import spec
from perfbench.lib.devtrace import DeviceTrace, Op

PEAK = spec.peaks()["NVIDIA H100 80GB HBM3"]
S = 1 << 27  # the cells' merged slots: 8 workers of 2^24
CALL = ("order_key_tails", "launches", 1, (S, 23))


@pytest.fixture
def counts(monkeypatch):
    """Fresh program counts as a traced run leaves them: `calls` calls of
    2^26 records in 2^27 slots, `tied` records in runs and `moved` of
    them moved a call (None: the count is not kept)."""
    from repro_torch.obs import device
    from repro_torch.obs.metrics import MetricsRegistry

    monkeypatch.setattr(device, "counters", MetricsRegistry())
    monkeypatch.setattr(device, "device_counts", device.DeviceCounts())

    def fill(calls, tied, moved):
        for _ in range(calls):
            device.counters.counter("exchange.records", 1 << 26)
            device.counters.counter("exchange.slots", S)
            device.device_counts.add("key_tail.records",
                                     torch.tensor(tied, dtype=torch.int64))
            if moved is not None:
                device.device_counts.add(
                    "key_tail.moved", torch.tensor(moved, dtype=torch.int64))
    return fill


def _ctx(launches, kernel_s):
    ops = [Op("bitonic_tile", 0.0, 0.002, 0.0)]
    if kernel_s:
        ops += [Op("(anonymous namespace)::key_tail_find("
                   "(anonymous namespace)::Stage)", 0.002,
                   0.002 + kernel_s / 2, 0.001),
                Op("void (anonymous namespace)::key_tail_order<1024, 16, "
                   "true>((anonymous namespace)::Stage, unsigned int*)",
                   0.003 + kernel_s / 2, 0.003 + kernel_s, 0.002),
                Op("Memset (Device)", 0.0019, 0.00195, 0.0009)]
    return types.SimpleNamespace(
        peaks=PEAK, trace=DeviceTrace(ops, [], 0.0, 0.1),
        launches=launches, trace_calls=1)


@pytest.mark.parametrize("calls,traced,moved", [
    (5, 5, 39_976_904), (12, 5, 39_976_904), (5, 5, 0)],
    ids=["counts_of_the_traced_calls", "counts_of_more", "none_moved"])
def test_the_key_tail_roofline_is_least_bytes_over_its_kernel_time(
        counts, calls, traced, moved):
    # daytona10's ties: 44.0 M records in runs of 2^26, 40.0 M of them
    # moved: 7.98 GB a call (0.62 GB where none moves)
    tied = 43_992_206
    counts(calls, tied, moved)
    call = 4 * (1 << 26) + 8 * tied + 8 * 23 * moved
    launches = [CALL[:2] + (traced, CALL[3]),
                ("gather_slot_rows", "launches", traced, (S, 1 << 26, 23))]
    got = spec.metric_reader("key_tail_roofline")(_ctx(launches,
                                                       traced * 0.008))
    assert got == pytest.approx(100 * traced * call / 3.35e12
                                / (traced * 0.008))
    assert (25 < got < 35) if moved else (2 < got < 3)


@pytest.mark.parametrize("case", ["no_call", "no_kernel_time", "no_counts",
                                  "no_moved_count", "untraced"])
def test_the_key_tail_roofline_is_silent_without_its_readings(counts, case):
    if case != "no_counts":
        counts(1, 1000, None if case == "no_moved_count" else 500)
    ctx = _ctx([] if case == "no_call" else [CALL],
               0.0 if case == "no_kernel_time" else 0.001)
    if case == "untraced":
        ctx.trace = None
    assert spec.metric_reader("key_tail_roofline")(ctx) is None
