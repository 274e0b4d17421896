"""Spans and counters inside the port's device work.

  span(name)  a `torch.profiler.record_function` range named `name`, opened
              only while a torch profiler is capturing; otherwise the one
              check of the profiler's own flag and nothing more. There is
              no switch of its own: tracing is on exactly when a profiler
              is. Kineto records these ranges on the clock of the CUDA
              activity it traces, so a device operation can be put down
              to the span that was open when the host launched it.
  counters    a MetricsRegistry held by this module, always on. The port
              counts into it host integers taken from shapes, never from
              device values (no `.item()`, no synchronise).
  device_counts  counts that only the device knows, always on: 0-d
              tensors added on the device where they are counted.
              `value(name)` reads one as an int, which waits for the
              device: read after the work.

The spans of the in-memory sort, opened in core/exoshuffle.py and, for
the through mode's rows on a rank mesh, core/payload.py:

  exoshuffle.call      distributed_sort, distributed_sort_payload: the
                       whole call; every span below nests in it
  sort.map             _exchange: bitonic sort of each worker's records
  sort.sample          _exchange, with sample_fraction > 0 only: the
                       splitters sampled from the sorted keys, gathered
                       across ranks, sorted and cut at their quantiles
                       (sampled_worker_boundaries)
  sort.partition       _exchange: worker boundaries (unless sampled), the
                       partition kernel
  sort.pack            _exchange: header block gathers, pads, overflow flag
  sort.exchange        _exchange: the key, id and count exchanges (a
                       transpose copy without a mesh)
  payload.pack         core/payload.send_rows (through mode on a rank mesh
                       only): the rows' local indices and the send-side
                       row gather
  payload.exchange     core/payload.send_rows (through mode on a rank mesh
                       only): the rows' exchange
  sort.merge           _shuffle_round, _sort_shard_payload: the merge
                       tournament
  payload.join         _sort_shard_payload (through mode), opened twice a
                       call: the arrival slots built before the merge
                       (core/payload.arrival_slots), then the ids and rows
                       gathered by slot after it (core/payload.
                       gather_by_slot: one launch of the slot gather
                       kernel on the card); without a mesh the only row
                       move, each row gathered from its producer's input,
                       on a mesh from the received blocks
  sort.key_tail        _sort_shard_payload with key_bytes=10: the runs of
                       equal key words found, their records ordered by
                       key bytes 4-9 and moved (core/keytail.py): on the
                       card one memset and three launches of the key-tail
                       kernel (kernels/csrc/key_tail.cu), and under sampled
                       splitters one host read of its scratch size
  sort.overflow_check  around each any_across: the `.any()` and the
                       host's wait on it

No name is a prefix of another. The counters: `exchange.records`, the
records the held workers send (wl·n), and `exchange.slots`, the block
slots they send (wl·W·C), both host integers counted in `_exchange` at
each exchange; the first over the second is the share of slots that
carry a record, the rest pads. In `device_counts`: `key_tail.records`,
counted in `_sort_shard_payload` with key_bytes=10, the records the
key-tail stage found in runs of equal key words and ordered; over
`exchange.records`, the share of records whose order needed the key's
bytes 4-9. `key_tail.moved`, counted in core/keytail.order_key_tails on
the card, the records whose place the kernel changed. `exchange.peak_worker_records`, counted in
`_sort_shard_payload` with sample_fraction > 0, the most records that
any held worker received in the call (int64); times W over
`exchange.records`, how far the sampled splitters leave the busiest
worker above the mean.

To take a trace of a sort:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exoshuffle.distributed_sort_payload(keys, ids, payload,
                                            num_workers=8)
        torch.cuda.synchronize()
    prof.export_chrome_trace("sort_trace.json")  # perfetto, chrome://tracing

This module imports torch; `repro_torch.obs` does not import it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.obs.metrics import MetricsRegistry

counters = MetricsRegistry()


class DeviceCounts:
    """Named totals kept as 0-d tensors where they are counted: adding
    launches a device add and never waits."""

    def __init__(self):
        self._totals: dict[str, torch.Tensor] = {}

    def add(self, name: str, value: torch.Tensor) -> None:
        total = self._totals.get(name)
        self._totals[name] = value.detach().clone() if total is None \
            else total + value

    def value(self, name: str) -> int | None:
        """The total as an int (waits for the device); None if never
        counted."""
        total = self._totals.get(name)
        return None if total is None else int(total)


device_counts = DeviceCounts()

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context manager: a profiler range named `name` while a torch
    profiler captures, else a shared no-op."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


__all__ = ["counters", "device_counts", "span"]
