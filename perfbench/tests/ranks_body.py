"""A rank body for the tests of perfbench/lib/ranks.py: the port's sort by
the whole 10-byte key over a rank mesh.

Rank r of G holds records [r n, (r + 1) n) of the configuration's
`records` (n = records / G), made from the seed by reference/key10.py,
and sorts them with `distributed_sort_payload(..., key_bytes=10,
mesh=mesh)` over the configuration's W workers. Its check compares each
of its workers' output with the plain 10-byte order of all the records
cut at the workers' equal ranges, and its records with the seed's.

The wraps below plant a fault on one rank, and `top16_order` is the
control (`CONTROL`, as a driver names it); they reach the ranks by
pickle, so they live here at module level.
"""
from __future__ import annotations

import sys
import time
import types

from perfbench.lib.outcome import Check, sync
from perfbench.lib.ranks import Rank
from perfbench.reference import key10
from perfbench.reference import sort as ref

SHAPE = "uniform"
CONTROL = "ranks_body.top16_order"


def body(cell, mesh, *, seed: int, device, wrap=None) -> Rank:
    from repro_torch.core.exoshuffle import distributed_sort_payload

    sort = distributed_sort_payload if wrap is None else wrap(
        distributed_sort_payload)
    total, w = int(cell.config["records"]), int(cell.config["workers"])
    lo, hi = mesh.share(total)
    keys, ids, payload = key10.records_t(lo, hi - lo, seed, SHAPE, device)
    kw = dict(num_workers=w, mode=cell.traffic["payload_mode"],
              device=device, key_bytes=10, mesh=mesh)

    def call():
        out = sort(keys, ids, payload, **kw)
        sync(device)
        return out

    def check(out):
        k, i, p = key10.records_t(lo, hi - lo, seed, SHAPE, device)
        changed = int(((keys != k) | (ids != i) | (payload != p).any(-1))
                      .sum())
        sk, si = key10.lex_order(total, seed, SHAPE, device)
        starts = ref.range_starts(sk, ref.equal_bounds(w))
        wl, w0 = mesh.workers_per_rank, mesh.worker_lo
        mk, mv, pout, valid, overflow = out
        pw = pout.shape[-1]
        segs = [(mk.view(wl, -1)[d], mv.view(wl, -1)[d],
                 pout.view(wl, -1, pw)[d], int(valid[d])) for d in range(wl)]
        bad = key10.compare_segments(segs, sk, si, starts[w0:w0 + wl + 1],
                                     seed)
        return [Check("mismatched_records", bad, 0),
                Check("input_changed_records", changed, 0),
                Check("overflow", int(bool(overflow)), 0)]

    return Rank(call=call, check=check, records=hi - lo,
                metric="resident_sort_records_per_s",
                readings={"workers": w})


def top16_order(keys, ids, payload, *, num_workers: int, mesh, **_):
    """The control in the program's place on each rank: every rank's
    records gathered and ordered by the top 16 bits of the key word, then
    the id (the key at a lower precision, as controls.py orders indy's),
    and this rank's workers' equal ranges of that order (W divides 2^16,
    so the ranges hold whole groups of the 16 bits), in the program's
    output format."""
    import torch
    import torch.distributed as dist

    from perfbench.reference import gen

    def gathered(x):
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.cat(parts)

    k, i, p = gathered(keys), gathered(ids), gathered(payload)
    sk, si = ref.lex_order(k, i, key_bits=16)
    rows = p.index_select(0, si)  # ids are the records' positions
    starts = ref.range_starts(sk >> 16, ref.equal_bounds(num_workers) >> 16)
    wl, w0 = mesh.workers_per_rank, mesh.worker_lo
    counts = [int(starts[w0 + d + 1] - starts[w0 + d]) for d in range(wl)]
    width = max(max(counts), 1)
    out = [torch.full((wl, width), -1, dtype=torch.int32, device=k.device)
           for _ in range(2)]
    pout = torch.zeros((wl, width, p.shape[-1]), dtype=torch.int32,
                       device=k.device)
    for d in range(wl):
        lo, m = int(starts[w0 + d]), counts[d]
        out[0][d, :m] = gen.to_u32(sk[lo:lo + m])
        out[1][d, :m] = gen.to_u32(si[lo:lo + m])
        pout[d, :m] = rows[lo:lo + m]
    return (out[0].reshape(-1), out[1].reshape(-1),
            pout.reshape(-1, p.shape[-1]),
            torch.tensor(counts, dtype=torch.int32), torch.tensor(False))


def _on_rank(rank: int, fault):
    """A wrap that runs `fault(entry, args, kw, calls)` in place of the
    entry on rank `rank`, `calls` counting that rank's calls from 1."""
    def wrap(entry):
        calls = [0]

        def sort(*args, **kw):
            if kw["mesh"].rank != rank:
                return entry(*args, **kw)
            calls[0] += 1
            return fault(entry, args, kw, calls[0])
        return sort
    return wrap


def _raise_at_second_call(entry, args, kw, calls):
    if calls == 2:
        raise RuntimeError("planted: rank 1 fails at its second call")
    return entry(*args, **kw)


def _hang(entry, args, kw, calls):
    time.sleep(3600)  # never reaches the sort's first collective


def _alter_a_row(entry, args, kw, calls):
    mk, mv, pout, valid, ovf = entry(*args, **kw)
    pout = pout.clone()
    pout[0, 3] ^= 1
    return mk, mv, pout, valid, ovf


def _load_flax(entry, args, kw, calls):
    sys.modules.setdefault("flax", types.ModuleType("flax"))
    return entry(*args, **kw)


def raises_on_rank1(entry):
    return _on_rank(1, _raise_at_second_call)(entry)


def hangs_on_rank2(entry):
    return _on_rank(2, _hang)(entry)


def alters_a_row_on_rank3(entry):
    return _on_rank(3, _alter_a_row)(entry)


def loads_flax_on_rank2(entry):
    return _on_rank(2, _load_flax)(entry)
