"""The key-tail kernel (kernels/csrc/key_tail.cu, launched by
core/keytail.order_key_tails on the card) against the card's bandwidth:
the least bytes of its traced calls over the profiler's device time of
the kernels whose name holds key_tail.

A call over S merged slots of pw-word rows must read each valid key word
once and each tied record's key bytes 4-9 (8 bytes), and must read and
write the id and row of each record whose place changes (its key bytes
within the row): 4 V + 8 T + 8 pw X bytes for V valid, T tied and X moved
records. V, T and X come from the program's counts over the same calls,
`exchange.records`, `key_tail.records` and `key_tail.moved`, scaled to
the call by S over `exchange.slots`; so the counts may cover more calls
than were traced. The kernel moves more than X where it copies a whole
run through its stage, which this share counts against it. None where
the program launched no such kernel or keeps no such counts."""
from perfbench.lib import hooks, roofline

KERNEL = "key_tail"  # key_tail_find, key_tail_order<...>
COUNTER = "order_key_tails"  # the wrapper that logs each call's (S, pw)


def read(ctx):
    peak = getattr(ctx, "peaks", {}).get("hbm_bytes_per_s")
    if not peak or getattr(ctx, "trace", None) is None:
        return None
    calls = hooks.launched(getattr(ctx, "launches", []), COUNTER)
    if not calls:
        return None
    try:
        from repro_torch.obs.device import counters, device_counts
    except ImportError:
        return None
    tied = device_counts.value("key_tail.records")
    moved = device_counts.value("key_tail.moved")
    records = counters.counter_value("exchange.records")
    slots = counters.counter_value("exchange.slots")
    if tied is None or moved is None or not records or not slots:
        return None
    nbytes = sum(s * (4 * records + 8 * tied + 8 * pw * moved) / slots * n
                 for (s, pw), n in calls)
    return roofline.share(nbytes, ctx.trace.seconds(KERNEL), peak)
