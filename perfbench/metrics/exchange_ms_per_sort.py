"""Device milliseconds a sort spends in its exchanges: the operations
launched inside the port's `sort.exchange` span (the headers, ids and
counts, core/exoshuffle._exchange) and `payload.exchange` span (the
payload rows, core/payload.send_rows, opened on a rank mesh only), per
traced call. Without a mesh the exchange is a transpose in one
process."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.exchange", "payload.exchange")
