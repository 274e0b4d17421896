"""The slot gather kernel (kernels/csrc/slot_gather.cu, called by
core/payload.gather_by_slot) against the card's bandwidth: the least
bytes of every launch in the traced part, from its (S, R, pw) shape,
over the profiler's device time of the kernels whose name holds
gather_slot_rows.

A launch gathers S slots of pw-word rows: it writes S rows and S ids
and reads the S merged slots, 4 * pw + 4 + 4 bytes a slot, and reads
each of its R input rows once, 4 * pw bytes a row. R is 0 on a rank
mesh, where the rows read are the received blocks; the slot side alone
is then the bound."""
from perfbench.lib import hooks, roofline

KERNEL = "gather_slot_rows"


def read(ctx):
    peak = getattr(ctx, "peaks", {}).get("hbm_bytes_per_s")
    if not peak or getattr(ctx, "trace", None) is None:
        return None
    nbytes = sum((s * (4 * pw + 8) + r * 4 * pw) * n for (s, r, pw), n in
                 hooks.launched(getattr(ctx, "launches", []), KERNEL))
    return roofline.share(nbytes, ctx.trace.seconds(KERNEL), peak)
