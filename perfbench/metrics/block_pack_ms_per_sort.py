"""Device milliseconds a sort spends cutting its sorted records into
blocks: the operations launched inside the port's `sort.partition` and
`sort.pack` spans (the partition kernel, the offsets, the header block
gathers and pads, core/exoshuffle._exchange), per traced call."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "sort.partition", "sort.pack")
