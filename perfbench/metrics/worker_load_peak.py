"""How far the busiest worker's load stands above the mean: 100 times
the port's `exchange.peak_worker_records` count (the most records that
any held worker received, added on the card each call that samples its
splitters, in repro_torch.obs.device.device_counts) over the records a
worker receives on average, the counter `exchange.records` (the records
sent, in repro_torch.obs.device.counters) over the cell's W workers,
both over the traced calls (the driver gives the program fresh counts
before them), read after the traced part. 100 is a perfect
balance. None where the program keeps no such count."""


def read(ctx):
    workers = getattr(ctx, "workers", 0)
    if getattr(ctx, "trace", None) is None or not workers:
        return None
    try:
        from repro_torch.obs.device import counters, device_counts
    except ImportError:
        return None
    peak = device_counts.value("exchange.peak_worker_records")
    records = counters.counter_value("exchange.records")
    if peak is None or not records:
        return None
    return 100.0 * peak * workers / records
