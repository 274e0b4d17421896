"""Payload movement strategies for the distributed sort.

Port of src/repro/core/payload.py. A gensort record is a key + payload;
the shuffle kernels sort (key: u32, id: u32) headers, and this module
decides how the wide payload rows follow their header:

  - "through" (paper-faithful): the merge carries each received
    record's arrival slot (block p, position j: p*C + j) in place of its
    id (`arrival_slots`), and `gather_by_slot` gathers the ids and
    payload rows by slot after it. Where the rows are is this module's
    decision, taken from the mesh: on a rank mesh they cross ranks, so
    `send_rows` packs them beside their headers and exchanges them
    before the merge, and the gather reads the received blocks; without
    a mesh every producer's rows are in the process's own tensor, and
    the gather reads each output row straight from its producer's input
    (block p = slot // C is the producer): no send blocks, no exchange
    of rows;

  - "late": the shuffle moves only the headers; after the final merge
    each worker fetches the payload rows of its output records from
    their producers with one more exchange, keyed by global record id.

As in core/exoshuffle.py the held workers (all W, or a rank's W/G) are
the leading axis of every tensor, and each all_to_all of the reference
is core/collectives.all_to_all_tiled, (Wl_src, W_dst, C, ...) ->
(Wl_dst, W_src, C, ...): a transpose without a mesh. Ids are u32 tensors
(int32 bit storage); every comparison, division and subtraction on them
runs on int64 carriers (kernels/u32.py), so the pad id 0xFFFFFFFF and
ids >= 2^31 keep their unsigned order and wrap as the reference's do;
the plain version of `gather_by_slot`'s gather (kernels/slot_gather.py)
alone compares the int32 bits without a mesh, against bounds below 2^31
where the two orders give the same answer.

Global record ids: id // records_per_worker is the producing worker (the
data/gensort.py layout), and a producer's row of an id is `local_rows`.
The slot join relies on the layout: each source block is a slice of its
producer's (key, id)-sorted run, and every id of producer p lies below
every id of producer q > p, so among equal keys the slot order is the
id order and merging (key, slot) gives the same order as merging
(key, id), record for record.
"""
from __future__ import annotations

import torch

from repro_torch.core import sortlib
from repro_torch.core.collectives import all_to_all_tiled, worker_ids
from repro_torch.kernels import u32
from repro_torch.kernels.slot_gather import gather_slot_rows
from repro_torch.obs.device import span


def take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-worker row gather: rows (W, m, pw), idx (W, k) int64 (or, with
    W = 1, int32) indices into each worker's m rows -> (W, k, pw)."""
    w, m, pw = rows.shape
    if w > 1:
        idx = idx + torch.arange(w, dtype=torch.int64,
                                 device=idx.device)[:, None] * m
    flat = rows.reshape(w * m, pw).index_select(0, idx.reshape(-1))
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

    The through mode does not call it: its merge carries arrival slots
    and `gather_by_slot` gathers by them, which gives the same rows
    without the sort and the search, because under the id layout above
    the (key, slot) and (key, id) orders agree. It stays as the port's
    counterpart of the reference's join and the oracle the slot gather
    is tested against.
    """
    m = recv_ids.shape[-1]
    sids, perm = torch.sort(u32.widen(recv_ids), dim=-1, stable=True)
    pos = torch.searchsorted(sids, u32.widen(merged_ids)).clamp_(0, m - 1)
    return take_rows(recv_payload, torch.gather(perm, -1, pos))


def arrival_slots(rcounts: torch.Tensor, capacity: int) -> torch.Tensor:
    """The arrival slot of each received block position.

    rcounts: (Wl_dst, W_src) int32 records received from each source.
    Returns (Wl, W_src, C) u32: p*C + j where j < min(rcounts[d, p], C),
    0xFFFFFFFF (the pad) elsewhere. The cap keeps an overflowing block's
    C real records, as sortlib.gather_range_blocks packs them. W_src*C
    is at most 2^31, so a slot's int32 bits are its value
    (`gather_by_slot` works on them as int32) and every slot sorts below
    the pad.
    """
    w = rcounts.shape[-1]
    if w * capacity > 1 << 31:
        raise ValueError(f"{w} blocks of {capacity} slots: more than 2^31 "
                         "slots a worker")
    dev = rcounts.device
    slots = torch.arange(w * capacity, dtype=torch.int32,
                         device=dev).reshape(w, capacity)
    j = torch.arange(capacity, dtype=torch.int32, device=dev)
    return torch.where(j < rcounts[..., None], slots, u32.PAD)


def local_rows(ids, first_ids, n: int) -> torch.Tensor:
    """The row of each u32 id among a producer's n rows whose first id
    is `first_ids` (int64, broadcast against ids): min((id - first)
    mod 2^32, n - 1) on int64 carriers, so ids outside those rows (the
    pad, and foreign ids below them as above them) take the last row."""
    return torch.clamp((u32.widen(ids) - first_ids) & u32.MASK, max=n - 1)


def send_rows(sent_ids, payload, *, capacity: int, mesh=None):
    """The through mode's rows where `gather_by_slot` reads them, moved
    before the merge (so that an exchange may overlap it).

    sent_ids: (Wl_src, W_dst, C) the sent blocks' ids; payload: (Wl, n,
    pw) the held workers' input rows. Without a mesh every producer's
    rows are already in the process: returns `payload` itself, and
    nothing is packed or exchanged. On a rank mesh the rows cross ranks:
    each sent block's rows are packed beside its headers (`local_rows`,
    so pad and foreign ids take the sender's last row) and exchanged;
    returns (Wl_dst, W_src, C, pw), aligned with the received ids."""
    if mesh is None:
        return payload
    wl, w = sent_ids.shape[:2]
    n, pw = payload.shape[1:]
    with span("payload.pack"):
        first = worker_ids(mesh, w, sent_ids.device)[:, None, None] * n
        bp = take_rows(payload,
                       local_rows(sent_ids, first, n).reshape(wl, -1))
    with span("payload.exchange"):
        return exchange_payload_blocks(bp.reshape(wl, w, capacity, pw),
                                       mesh)


def gather_by_slot(recv_ids, rows, merged_slots, rcounts, *, mesh=None):
    """The ids and payload rows of the merged records, by arrival slot.

    recv_ids: (Wl, m) u32 ids in arrival order (m = W_src*C); rows:
    `send_rows`'s, for the same mesh; merged_slots: (Wl, m) the merge's
    `arrival_slots` lanes; rcounts: (Wl, W_src) int32. Returns (ids,
    rows): (Wl, m) and (Wl, m, pw) in merged order. The id in slot s is
    recv_ids[s], and a pad slot takes the first pad of arrival order
    (block p's slot p*C + rcounts[p] for the first p with rcounts[p] <
    C), as `align_payload_to_merge` joins every pad id. The row of slot
    s is, on a mesh, row s of the received blocks; without a mesh,
    producer p = s // C's input row local_rows(id, p*n, n), the row a
    pack would have sent. One `kernels/slot_gather.gather_slot_rows`
    gathers both (one kernel launch on the card), and nothing waits for
    the device.

    Without a mesh the plain version's indices are int32: more than
    2^31 slots or input rows in the process are refused. On a mesh each
    worker's slots are int32 (`arrival_slots` keeps them below 2^31) and
    the flat index is int64, since a rank may hold more than 2^31 slots
    in all.
    """
    if mesh is None:
        w, m = recv_ids.shape
        w_src, n = rcounts.shape[-1], rows.shape[1]
        if w * m > 1 << 31 or w_src * n > 1 << 31:
            raise ValueError(f"{w} x {m} slots of {w_src} x {n} rows: more "
                             "than 2^31 in one process")
    return gather_slot_rows(recv_ids, rows, merged_slots, rcounts,
                            from_input=mesh is None)


def exchange_payload_blocks(block_payload: torch.Tensor,
                            mesh=None) -> torch.Tensor:
    """The 'through' mode's wire hop: (Wl_src, W_dst, C, pw) payload
    blocks -> (Wl_dst, W_src, C, pw)."""
    return all_to_all_tiled(block_payload, mesh, what="payload")


def late_fetch_payload(final_ids, local_payload, *, num_workers: int,
                       records_per_worker: int, capacity: int,
                       impl: str = "kernel", mesh=None):
    """'late' mode: fetch payload rows for `final_ids` from their producers.

    final_ids: (Wl, m) u32 global record ids each held worker's output
    needs (pads 0xFFFFFFFF allowed); local_payload: (Wl, n, pw) the rows
    each held worker produced (worker p's row r holds global id p*n + r,
    n = records_per_worker, p a global worker id). num_workers is the
    global W; with a mesh the held workers are the rank's. capacity: the
    per-(requester, producer) request block. Returns (Wl, m, pw) rows
    aligned with final_ids and the overflow flag (a bool tensor of this
    process's request blocks).

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
    wl, m = final_ids.shape
    w = int(num_workers)
    n = int(records_per_worker)
    dev = final_ids.device
    fid = u32.widen(final_ids)
    # Producer of each id; pads go round-robin so no block overflows.
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    prod = torch.clamp(fid // n, max=w - 1)
    prod = torch.where(fid == u32.MASK, pos % w, prod)
    sprod, perm = torch.sort(prod, dim=-1, stable=True)
    sids = torch.gather(final_ids, -1, perm)
    bounds = torch.arange(1, w, dtype=torch.int32, device=dev)
    starts, counts = sortlib.partition_sorted(sprod.to(torch.int32), bounds,
                                              impl=impl)
    req_blocks, _, overflow = sortlib.gather_range_blocks(
        sids, sids, starts, counts, capacity)  # (Wl_req, W_prod, C)
    # Requests travel requester -> producer.
    recv_req = all_to_all_tiled(req_blocks, mesh,
                                what="requests")  # (Wl_prod, W_req, C)
    # Serve: the local row of each requested id (foreign and pad ids
    # take the last row).
    my = worker_ids(mesh, w, dev)[:, None, None] * n
    served = take_rows(local_payload,
                       local_rows(recv_req, my, n).reshape(wl, -1))
    pw = served.shape[-1]
    # Rows travel producer -> requester (the reverse exchange).
    back = all_to_all_tiled(served.reshape(wl, w, capacity, pw), mesh,
                            what="rows")  # (Wl_req, W_prod, C, pw)
    # Un-block: the row of the request at sorted position s of block p
    # is row s - starts[p] of that block.
    inv = torch.empty_like(perm).scatter_(-1, perm, pos.expand(wl, m))
    j = inv - torch.gather(starts.to(torch.int64), -1, prod)
    row = prod * capacity + j.clamp_(0, capacity - 1)
    return take_rows(back.reshape(wl, w * capacity, pw), row), overflow
