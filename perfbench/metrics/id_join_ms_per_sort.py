"""Device milliseconds a sort spends putting payload rows in output
order: the operations launched inside the port's `payload.join` span
(the id join: a stable sort of the arrival ids, a binary search, the
permutation gather and the row gather,
core/exoshuffle._sort_shard_payload), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "payload.join")
