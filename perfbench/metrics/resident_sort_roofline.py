"""Whole device sort against the card's bandwidth: 200 bytes a record
(each read once and written once) over the peak, over the device time
of a traced call (the profiler's busy time over the traced calls, the
union of every kernel and copy they ran). It counts the same work
whatever implements the sort."""
from perfbench.lib import roofline


def read(ctx):
    peak = getattr(ctx, "peaks", {}).get("hbm_bytes_per_s")
    if not peak or getattr(ctx, "trace", None) is None or \
            not getattr(ctx, "trace_calls", 0):
        return None
    return roofline.share(
        roofline.whole_sort_bytes(ctx.records_per_call) * ctx.trace_calls,
        ctx.trace.busy_s(), peak)
