"""Device milliseconds a sort spends putting ids and payload rows in
merged order: the operations launched inside the port's `payload.join`
span, per traced call. The span opens twice a through call in
core/exoshuffle._sort_shard_payload: before the merge around
core/payload.arrival_slots (each received position's arrival slot), and
after it around core/payload.gather_by_slot, one launch of
kernels/csrc/slot_gather.cu (`gather_slot_rows`) that gathers each
merged slot's id and row (without a mesh from its producer's input, on
a mesh from the received blocks)."""
from perfbench.lib import stages


def read(ctx):
    return stages.ms_per_call(ctx, "payload.join")
