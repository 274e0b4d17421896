"""Payload movement strategies for the distributed sort.

Port of src/repro/core/payload.py. A gensort record is a key + payload;
the shuffle kernels sort (key: u32, id: u32) headers, and this module
decides how the wide payload rows follow their header:

  - "through" (paper-faithful): the payload rows ride the shuffle's
    exchange beside their headers, and after the merge an id join puts
    them in output order;

  - "late": the shuffle moves only the headers; after the final merge
    each worker fetches the payload rows of its output records from
    their producers with one more exchange, keyed by global record id.

As in core/exoshuffle.py the W workers are the leading axis of every
tensor, and each all_to_all of the reference is the transpose
(W_src, W_dst, C, ...) -> (W_dst, W_src, C, ...). Ids are u32 tensors
(int32 bit storage); every comparison, division and subtraction on them
runs on int64 carriers (kernels/u32.py), so the pad id 0xFFFFFFFF and
ids >= 2^31 keep their unsigned order and wrap as the reference's do.

Global record ids: id // records_per_worker is the producing worker (the
data/gensort.py layout).
"""
from __future__ import annotations

import torch

from repro_torch.core import sortlib
from repro_torch.kernels import u32


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-worker row gather: rows (W, m, pw), idx (W, k) int64 indices
    into each worker's m rows -> (W, k, pw)."""
    w, m, pw = rows.shape
    base = torch.arange(w, dtype=torch.int64, device=idx.device)[:, None] * m
    flat = rows.reshape(w * m, pw).index_select(0, (idx + base).reshape(-1))
    return flat.reshape(w, idx.shape[-1], pw)


def align_payload_to_merge(recv_ids, recv_payload, merged_ids):
    """Reorder received payload rows to follow the post-merge order.

    recv_ids: (W, m) u32 global ids in arrival (pre-merge) order;
    recv_payload: (W, m, pw) rows aligned with recv_ids; merged_ids:
    (W, m) the same multiset of ids in post-merge order. Returns
    (W, m, pw) payload aligned with merged_ids.

    An id join, as in the reference: a stable sort of the arrival ids,
    then a left binary search of each merged id. Pad ids (0xFFFFFFFF)
    all join the first pad row in arrival order.
    """
    m = recv_ids.shape[-1]
    sids, perm = torch.sort(u32.widen(recv_ids), dim=-1, stable=True)
    pos = torch.searchsorted(sids, u32.widen(merged_ids)).clamp_(0, m - 1)
    return take_rows(recv_payload, torch.gather(perm, -1, pos))


def exchange_payload_blocks(block_payload: torch.Tensor) -> torch.Tensor:
    """The 'through' mode's wire hop: (W_src, W_dst, C, pw) payload
    blocks -> (W_dst, W_src, C, pw)."""
    return block_payload.transpose(0, 1).contiguous()


def late_fetch_payload(final_ids, local_payload, *, num_workers: int,
                       records_per_worker: int, capacity: int,
                       impl: str = "kernel"):
    """'late' mode: fetch payload rows for `final_ids` from their producers.

    final_ids: (W, m) u32 global record ids each worker's output needs
    (pads 0xFFFFFFFF allowed); local_payload: (W, n, pw) the rows each
    worker produced (worker p's row r holds global id p*n + r, n =
    records_per_worker). capacity: the per-(requester, producer) request
    block. Returns (W, m, pw) rows aligned with final_ids and the
    overflow flag (a bool tensor).

    Requests are routed to producers with the shuffle's own
    fixed-capacity block protocol: one stable sort of the producer ids
    (its permutation gives both the sorted request ids and, inverted,
    each request's sorted position), the producer split by the partition
    kernel over all W rows in one launch, the request exchange, the
    serve, and the reverse exchange. Each output row then gathers its
    served row from (its producer, its position in that producer's
    block): no row is scattered (the one scatter inverts a permutation),
    so no two rows can target one place. A pad's row is the producer's
    last row, as in the reference; rows whose block overflowed the
    capacity are undefined (and `overflow` is set).
    """
    w, m = final_ids.shape
    n = int(records_per_worker)
    dev = final_ids.device
    fid = u32.widen(final_ids)
    # Producer of each id; pads go round-robin so no block overflows.
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    prod = torch.clamp(fid // n, max=num_workers - 1)
    prod = torch.where(fid == u32.MASK, pos % num_workers, prod)
    sprod, perm = torch.sort(prod, dim=-1, stable=True)
    sids = torch.gather(final_ids, -1, perm)
    bounds = torch.arange(1, num_workers, dtype=torch.int32, device=dev)
    starts, counts = sortlib.partition_sorted(sprod.to(torch.int32), bounds,
                                              impl=impl)
    req_blocks, _, overflow = sortlib.gather_range_blocks(
        sids, sids, starts, counts, capacity)  # (W_req, W_prod, C)
    # Requests travel requester -> producer.
    recv_req = req_blocks.transpose(0, 1)  # (W_prod, W_req, C)
    # Serve: the local row of each requested id (u32 arithmetic: foreign
    # and pad ids wrap and clamp to the last row).
    my = torch.arange(w, dtype=torch.int64, device=dev)[:, None, None] * n
    local_row = torch.clamp((u32.widen(recv_req) - my) & u32.MASK, max=n - 1)
    served = take_rows(local_payload, local_row.reshape(w, -1))
    pw = served.shape[-1]
    # Rows travel producer -> requester (the reverse exchange).
    back = exchange_payload_blocks(served.reshape(w, w, capacity, pw))
    # Un-block: the row of the request at sorted position s of block p
    # is row s - starts[p] of that block.
    inv = torch.empty_like(perm).scatter_(-1, perm, pos.expand(w, m))
    j = inv - torch.gather(starts.to(torch.int64), -1, prod)
    row = prod * capacity + j.clamp_(0, capacity - 1)
    return take_rows(back.reshape(w, w * capacity, pw), row), overflow
