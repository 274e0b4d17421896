"""The through mode's gather by arrival slot: the merged records' ids
and payload rows, in merged order (core/payload.gather_by_slot).

Replaces no TPU kernel: the reference joins the payload in XLA.

  * the CUDA kernel, csrc/slot_gather.cu — one launch a call: each
    merged slot's source row is worked out in registers and its row
    copied once, with 64-bit offsets;
  * the plain version — the same function as a composition of torch
    ops: each arrival slot's input row (`_input_rows`), the pad fix-up
    (`_pads_to_first_pad`), the worker offset and three index gathers.

Both take the row map from `from_input`: True where `rows` is the
producers' input (W_src, n, pw), every producer's rows in this process;
False where it is the received blocks, (Wl, W_src, C, pw), one row per
arrival slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, u32


def _input_rows(recv_ids, w_src: int, n: int):
    """The flat input row of each arrival slot without a mesh, (Wl*m,)
    int32: block p's producer's row p*n + local_rows(id, p*n, n), on the
    int32 bits. While W_src*n <= 2^31 the bits compare as the u32 values
    do on both sides of [p*n, p*n + n - 1], so ids below it or above it
    (the pad among them) take its last row, as in `local_rows`."""
    w, m = recv_ids.shape
    lo = torch.arange(w_src, dtype=torch.int32,
                      device=recv_ids.device)[:, None] * n
    hi = lo + (n - 1)
    rv = recv_ids.reshape(w, w_src, m // w_src)
    return torch.where(rv < lo, hi, torch.minimum(rv, hi)).reshape(-1)


def _pads_to_first_pad(merged_slots, rcounts):
    """merged_slots (W, m) int32 with each pad slot replaced by the
    worker's first pad of arrival order (block p's slot p*C + rcounts[p]
    for the first p with rcounts[p] < C; m - 1 where every block is
    full, which leaves no pad to replace). Worked out on the device."""
    m = merged_slots.shape[-1]
    cap = m // rcounts.shape[-1]
    rc = rcounts.to(torch.int64)
    block = torch.arange(rc.shape[-1], dtype=torch.int64,
                         device=rc.device) * cap
    first_pad = torch.where(rc < cap, block + rc, m - 1).amin(-1, True)
    return torch.where(merged_slots == u32.PAD, first_pad.to(torch.int32),
                       merged_slots)


def gather_slot_rows_plain(recv_ids, rows, merged_slots, rcounts, *,
                           from_input: bool):
    """The plain torch version: int32 indices without a mesh (the caller
    refuses more than 2^31 slots or rows), int64 on one."""
    w, m = recv_ids.shape
    pw = rows.shape[-1]
    if from_input:
        row = _input_rows(recv_ids, rcounts.shape[-1], rows.shape[1])
        index = torch.int32
    else:
        row, index = None, torch.int64
    base = torch.arange(w, dtype=index, device=recv_ids.device)[:, None] * m
    slot = (_pads_to_first_pad(merged_slots, rcounts) + base).reshape(-1)
    ids = recv_ids.reshape(-1).index_select(0, slot).reshape(w, m)
    flat = rows.reshape(1, -1, pw)
    if row is not None:
        slot = row.index_select(0, slot)
    # core/payload.take_rows on one worker's rows, inlined, so that the
    # ops are the composition's the kernel replaced, views included
    idx = slot[None]
    got = flat.reshape(flat.shape[1], pw).index_select(0, idx.reshape(-1))
    return ids, got.reshape(1, idx.shape[-1], pw).reshape(w, m, pw)


def _check(recv_ids, rows, merged_slots, rcounts, from_input):
    u32.require_u32(recv_ids, rows, merged_slots, rcounts)
    if recv_ids.ndim != 2 or merged_slots.shape != recv_ids.shape:
        raise ValueError(f"ids {tuple(recv_ids.shape)}, slots "
                         f"{tuple(merged_slots.shape)}: need equal (Wl, m)")
    w, m = recv_ids.shape
    if rcounts.ndim != 2 or rcounts.shape[0] != w or not rcounts.shape[1] \
            or m % rcounts.shape[1]:
        raise ValueError(f"rcounts {tuple(rcounts.shape)}: need (Wl, W_src) "
                         f"with W_src dividing m = {m}")
    if from_input:
        ok = rows.ndim == 3 and rows.shape[0] == rcounts.shape[1] \
            and rows.shape[1] > 0
        want = "(W_src, n, pw) input rows"
    else:
        ok = rows.ndim >= 2 and rows.numel() == w * m * rows.shape[-1]
        want = f"{w * m} received rows"
    if not ok or not rows.shape[-1]:
        raise ValueError(f"rows {tuple(rows.shape)}: need {want}")


def gather_slot_rows(recv_ids: torch.Tensor, rows: torch.Tensor,
                     merged_slots: torch.Tensor, rcounts: torch.Tensor, *,
                     from_input: bool):
    """The ids and rows of the merged slots: (Wl, m) and (Wl, m, pw).

    recv_ids: (Wl, m) u32 ids in arrival order (m = W_src * C);
    merged_slots: (Wl, m) the merge's arrival slots (pads 0xFFFFFFFF);
    rcounts: (Wl, W_src) int32; rows as the module docstring says. The
    id of slot s is recv_ids[s]; a pad slot takes the worker's first pad
    of arrival order. The row of slot s is, from the input, producer
    p = s // C's row local_rows(id, p*n, n); from the received blocks,
    row s of the worker's. All int32 storage and contiguous. CPU
    tensors take the plain version, CUDA tensors the kernel.
    """
    _check(recv_ids, rows, merged_slots, rcounts, from_input)
    if recv_ids.device.type == "cpu":
        return gather_slot_rows_plain(recv_ids, rows, merged_slots, rcounts,
                                      from_input=from_input)
    w, m = recv_ids.shape
    w_src, pw = rcounts.shape[1], rows.shape[-1]
    n = rows.shape[1] if from_input else 0
    ids = torch.empty_like(recv_ids)
    out = torch.empty((w, m, pw), dtype=rows.dtype, device=rows.device)
    if w * m:
        _build.launch("slot_gather", recv_ids, rows, merged_slots, rcounts,
                      ids, out, w, m, w_src, n, pw, int(from_input))
        _build.count_launch(gather_slot_rows,
                            shape=(w * m, w_src * n, pw))
    return ids, out


gather_slot_rows.launches = 0
gather_slot_rows.shapes = set()  # (slots S, input rows R, pw) launched at
