"""Device milliseconds a sort spends ordering its runs of equal key
words by key bytes 4-9: the operations launched inside the port's
`sort.key_tail` span (core/keytail.order_key_tails, called from
core/exoshuffle._sort_shard_payload with key_bytes=10), per traced
call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.key_tail")
