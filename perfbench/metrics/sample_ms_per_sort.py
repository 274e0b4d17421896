"""Device milliseconds a sort spends choosing its splitters: the
operations launched inside the port's `sort.sample` span (the sample of
the sorted keys, its gather across ranks, its bitonic sort and the
quantiles, core/exoshuffle.sampled_worker_boundaries, called from
`_exchange` when the sort is given a `sample_fraction`), per traced
call. None where the program opens no such span."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.sample")
