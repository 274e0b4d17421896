"""Least bytes a piece of work must move, from its shapes.

Each input byte is counted read once and each output byte written once,
whatever the implementation reads again. A roofline share is these
bytes over the card's peak bandwidth (lib/peaks.json), over the measured
time; none of the work here is bound by arithmetic.
"""
from __future__ import annotations

#: A record as the port lays it out: key, id and 23 payload words.
RECORD_BYTES = 100
HEADER_BYTES = 8  # (key, val) u32 pair


def whole_sort_bytes(records: int) -> int:
    """Sorting whole records: each read once and written once."""
    return 2 * RECORD_BYTES * int(records)


def bitonic_sort_bytes(rows: int, b: int) -> int:
    """One bitonic_sort_blocks launch over (rows, B) (key, val) pairs."""
    return 2 * HEADER_BYTES * int(rows) * int(b)


def share(nbytes: float, seconds: float, peak_bytes_per_s: float):
    """Percent of the peak, or None where nothing was timed."""
    if not nbytes or not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / peak_bytes_per_s / seconds
