"""The row gather's roofline: the least bytes of every logged
gather_slot_rows launch over the kernel's device time."""
import types

import pytest

from perfbench.lib import spec
from perfbench.lib.devtrace import DeviceTrace, Op

PEAK = spec.peaks()["NVIDIA H100 80GB HBM3"]

# the cell's gather: 2^27 slots of 23-word rows from 2^26 input rows
CELL_GATHER = (1 << 27, 1 << 26, 23)
CELL_GATHER_BYTES = 19_595_788_288  # 2^27 * (92 + 4 + 4) + 2^26 * 92


@pytest.mark.parametrize("launches,kernel_s,want_bytes", [
    ([], 0.0087, None),
    ([("gather_slot_rows", "launches", 1, CELL_GATHER)], 0.0, None),
    ([("gather_slot_rows", "launches", 5, CELL_GATHER)], 5 * 0.0087,
     5 * CELL_GATHER_BYTES),
    # on a rank mesh R = 0: the slot side alone
    ([("gather_slot_rows", "launches", 2, (1 << 20, 0, 23))], 0.001,
     2 * (1 << 20) * 100),
    ([("gather_slot_rows", "launches", 1, CELL_GATHER),
      ("gather_slot_rows", "launches", 1, (1 << 20, 0, 8)),
      ("bitonic_sort_blocks", "launches", 1, (8, 1 << 22))], 0.009,
     CELL_GATHER_BYTES + (1 << 20) * 40),
], ids=["no_launch", "no_kernel_time", "cell", "mesh", "mixed"])
def test_the_row_gather_roofline_is_least_bytes_over_its_kernel_time(
        launches, kernel_s, want_bytes):
    ops = [Op("bitonic_tile", 0.0, 0.002, 0.0)]
    if kernel_s:
        ops.append(Op("(anonymous namespace)::gather_slot_rows("
                      "(anonymous namespace)::Gather)", 0.002,
                      0.002 + kernel_s, 0.001))
    ctx = types.SimpleNamespace(
        peaks=PEAK, trace=DeviceTrace(ops, [], 0.0, 0.1),
        launches=launches, trace_calls=1)
    got = spec.metric_reader("row_gather_roofline")(ctx)
    if want_bytes is None:
        assert got is None
    else:
        assert got == pytest.approx(100 * want_bytes / 3.35e12 / kernel_s)
