"""Device milliseconds a sort spends packing payload rows for the
exchange: the operations launched inside the port's `payload.pack` span
(the row index arithmetic and the send-side row gather,
core/exoshuffle._sort_shard_payload), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "payload.pack")
