"""Device milliseconds a sort spends moving payload rows: the kernels
and copies launched inside core/payload.py's take_rows,
exchange_payload_blocks and align_payload_to_merge (the row gathers, the
exchange's copy and the id join), per traced call."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not ctx.trace_calls:
        return None
    sec = ctx.trace.seconds_launched_in("perfbench.payload.")
    return 1e3 * sec / ctx.trace_calls if sec > 0 else None
