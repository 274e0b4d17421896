"""Device milliseconds a sort spends in its map sort: the operations
launched inside the port's `sort.map` span (the bitonic sort of each
worker's records, core/exoshuffle._exchange), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.map")
