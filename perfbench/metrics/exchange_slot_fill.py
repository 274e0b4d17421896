"""Share of the exchanged block slots that carry a record: 100 times
the port's `exchange.records` counter over its `exchange.slots` counter
(core/exoshuffle._exchange, in repro_torch.obs.device.counters), read
after the traced part. A ratio, so it does not matter which calls were
counted; the rest of each block is pads. None where the program keeps
no such counters."""


def read(ctx):
    if getattr(ctx, "trace", None) is None:
        return None
    try:
        from repro_torch.obs.device import counters
    except ImportError:
        return None
    slots = counters.counter_value("exchange.slots")
    if not slots:
        return None
    return 100.0 * counters.counter_value("exchange.records") / slots
