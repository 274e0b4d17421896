"""Share of the sorted records that the key-tail stage had to order by
key bytes 4-9: 100 times the port's `key_tail.records` count (the
records found in runs of equal key words, counted on the card, in
repro_torch.obs.device.device_counts) over its `exchange.records`
counter (the records sent, in repro_torch.obs.device.counters), both
over the same calls, read after the traced part. None where the program
keeps no such count."""


def read(ctx):
    if getattr(ctx, "trace", None) is None:
        return None
    try:
        from repro_torch.obs.device import counters, device_counts
    except ImportError:
        return None
    tied = device_counts.value("key_tail.records")
    records = counters.counter_value("exchange.records")
    if tied is None or not records:
        return None
    return 100.0 * tied / records
