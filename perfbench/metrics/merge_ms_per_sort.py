"""Device milliseconds a sort spends merging the received blocks: the
operations launched inside the port's `sort.merge` span (the merge
tournament and the copies between its rounds,
core/exoshuffle._sort_shard_payload), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.merge")
