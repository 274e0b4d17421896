"""Device milliseconds a sort spends in its exchanges: the operations
launched inside the port's `sort.exchange` span (headers, ids and
counts, core/exoshuffle._exchange) and `payload.exchange` span (payload
rows, core/exoshuffle._sort_shard_payload), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.exchange", "payload.exchange")
