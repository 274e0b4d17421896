"""The bitonic sort kernel (kernels/csrc/bitonic_sort.cu) against the
card's bandwidth: the least bytes of every launch in the traced part,
from its (rows, B) shape, over the profiler's device time of the
kernels named bitonic_*."""
from perfbench.lib import hooks, roofline


def read(ctx):
    peak = getattr(ctx, "peaks", {}).get("hbm_bytes_per_s")
    if not peak or getattr(ctx, "trace", None) is None:
        return None
    nbytes = sum(roofline.bitonic_sort_bytes(*shape) * n for shape, n in
                 hooks.launched(ctx.launches, "bitonic_sort_blocks"))
    return roofline.share(nbytes, ctx.trace.seconds("bitonic_"), peak)
