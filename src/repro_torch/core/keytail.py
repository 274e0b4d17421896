"""Order records by the Sort Benchmark's whole 10-byte key: the key-tail
stage of `core/exoshuffle.distributed_sort_payload(..., key_bytes=10)`.

A record of the rules (CloudSort, GraySort; valsort checks it) is 100
bytes: a 10-byte key compared as unsigned bytes, left to right, then a
90-byte value. The port holds it as u32 words (int32 bits, kernels/u32):

  keys[i]         key bytes 0-3, big-endian: the word the kernels sort
  ids[i]          the record's global id: 4 value bytes
  payload[i, 0]   key bytes 4-7, big-endian
  payload[i, 1]   key bytes 8-9 in the high half, 2 value bytes in the low
  payload[i, 2:]  the other value bytes (21 words in a 100-byte record)

This is key-prefix sorting, as in AlphaSort: the map sort, the exchange
and the merge order (key bytes 0-3, id), so records whose leading words
differ already stand in the rules' order. `order_key_tails` then
reorders only the runs of equal leading words, by (key bytes 4-9, id).
A run never straddles two workers, because the workers' key ranges split
the leading 32 bits.

On the card the stage is one hand-written kernel (kernels/key_tail.py,
csrc/key_tail.cu: three launches), which finds each run, orders it by
its length's class and moves its ids and rows once. On the CPU it is the
plain version, `order_key_tails_plain`: the neighbouring pairs of equal
words gathered into a buffer, two stable sorts, index moves.

Under the workers' equal ranges the stage adds no wait for the host: it
holds at most a fixed capacity of neighbouring pairs of equal words
(`pair_capacity`, worked out from the shapes the way the exchange's
block capacity is), the plain version in a buffer of that size and the
kernel in lists and scratch sized from it, and pairs past it set the
call's overflow flag, as an overflowing exchange block does. A sort that
samples its splitters is told nothing of the key distribution, and
skewed keys tie far beyond the uniform mean (two thirds of the records
under CloudSort's Daytona skew): there the stage holds every pair and
never overflows (`stage_capacity` is the rule). The plain version then
counts the pairs and sizes its buffer to them, the kernel counts the
scratch its longest runs need: one host read a call each.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import key_tail, u32
from repro_torch.obs import device as obs_device

KEY_BYTES = (4, 10)  # the kernels' key word alone; the rules' whole key
TAIL_WORDS = 2  # payload words that carry key bytes 4-9
PAIR_FLOOR = 1 << 12  # least capacity: small sorts hold every tie they can


def pair_capacity(records_per_worker: int, num_workers: int, held: int,
                  slots: int, capacity_factor: float) -> int:
    """Pairs of neighbours with equal key words that one call's stage can
    hold over its `held` workers.

    Under uniform keys a worker's n records fall in 2^32 / W key words,
    so about n^2 W / 2^33 neighbouring pairs share their word; the
    capacity is `capacity_factor` times that over the held workers, at
    least PAIR_FLOOR, at most the held workers' `slots` - 1 pairs each."""
    n, w = int(records_per_worker), int(num_workers)
    mean = held * n * n * w / 2.0**33
    cap = max(PAIR_FLOOR, math.ceil(mean * capacity_factor))
    return min(cap, held * (int(slots) - 1))


def stage_capacity(records_per_worker: int, num_workers: int, held: int,
                   slots: int, capacity_factor: float, *,
                   sampled: bool) -> int | None:
    """The stage's buffer for one call: `pair_capacity` under the
    workers' equal ranges, whose ties the uniform mean bounds; None
    (every pair of the call, counted once a call) under sampled
    splitters, which are told nothing of the key distribution."""
    if sampled:
        return None
    return pair_capacity(records_per_worker, num_workers, held, slots,
                         capacity_factor)


def order_key_tails(keys, ids, rows, valid, capacity: int | None):
    """Reorder each worker's runs of equal key words by the rest of the
    key, in place.

    keys/ids: (Wl, M) u32 in (key word, id) order with pads past each
    worker's valid prefix; rows: (Wl, M, pw) their payload rows, pw >=
    TAIL_WORDS; valid: (Wl,) int32 valid prefix lengths. ids and rows are
    permuted within the runs so that each worker's valid prefix is in
    (key bytes 0-9, id) order; keys are unchanged (a run shares its
    word). Returns (tied, overflow), device tensors: the records found in
    runs (int64), and whether more than `capacity` neighbouring pairs
    share a word, in which case the order is unspecified. `capacity`
    None holds every pair, which waits for the device once. All int32
    storage and contiguous on one device, pw >= TAIL_WORDS (else raises).
    CPU tensors take the plain version, CUDA tensors the kernel
    (kernels/key_tail.py: pw up to what it takes; under overflow its
    `tied` counts every run), which adds the records it moved to the
    device count `key_tail.moved`.
    """
    check(keys, ids, rows, valid)
    if keys.device.type == "cpu":
        return order_key_tails_plain(keys, ids, rows, valid, capacity)
    tied, overflow, moved = key_tail.order_key_tails(keys, ids, rows, valid,
                                                     capacity)
    obs_device.device_counts.add("key_tail.moved", moved)
    return tied, overflow


def check(keys, ids, rows, valid) -> None:
    """Raise unless keys/ids are (Wl, M) u32, rows (Wl, M, pw) with pw >=
    TAIL_WORDS and valid (Wl,) int32, all contiguous on one device."""
    u32.require_u32(keys, ids, rows, valid)
    if keys.ndim != 2 or ids.shape != keys.shape:
        raise ValueError(f"keys {tuple(keys.shape)}, ids {tuple(ids.shape)}: "
                         "need equal (Wl, M)")
    if rows.ndim != 3 or rows.shape[:2] != keys.shape \
            or rows.shape[-1] < TAIL_WORDS:
        raise ValueError(f"rows {tuple(rows.shape)}: need (Wl, M, pw) with "
                         f"(Wl, M) = {tuple(keys.shape)} and pw >= "
                         f"{TAIL_WORDS}")
    if valid.shape != keys.shape[:1]:
        raise ValueError(f"valid {tuple(valid.shape)}: need "
                         f"({keys.shape[0]},)")


def order_key_tails_plain(keys, ids, rows, valid, capacity: int | None):
    """The plain torch version of `order_key_tails`: the neighbouring
    pairs of equal words compacted into a buffer of `capacity` pairs
    (counted first where None), ordered by (run, key bytes 4-7, key bytes
    8-9, position) with two stable sorts, ids and rows moved by index."""
    wl, m = keys.shape
    dev = keys.device
    flat_ids = ids.view(-1)
    flat_rows = rows.view(wl * m, rows.shape[-1])
    if m < 2:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.bool, device=dev))
    # pair (w, i): records i and i + 1 of worker w, both valid, one
    # word; compared along the flat rows, the mask drops i = M - 1
    pair = torch.empty((wl, m), dtype=torch.bool, device=dev)
    flat = keys.view(-1)
    torch.eq(flat[1:], flat[:-1], out=pair.view(-1)[:-1])
    pair &= torch.arange(1, m + 1, dtype=torch.int32, device=dev) < \
        valid.clamp(max=m)[:, None]
    if capacity is None:
        capacity = int(pair.sum())
    # the first capacity + 1 pairs, ascending; -1 past the last
    at = torch.nonzero_static(pair.view(-1), size=capacity + 1,
                              fill_value=-1)[:, 0]
    del pair
    overflow = at[-1] >= 0
    at = at[:capacity]  # the flat position of each pair's first record
    found = at >= 0
    # a pair runs on into the next one when that starts one record later
    # (never across workers: no pair starts at a worker's last slot)
    cont = torch.cat([at[1:], at.new_full((1,), -1)]) == at + 1
    run = torch.cumsum(found & ~torch.cat([cont.new_zeros(1), cont[:-1]]),
                       0)
    # the buffer: each pair's first record, then its second where the run
    # ends there; its records stand in position order, each once
    pos = torch.stack([at, at + 1], 1).view(-1).clamp(min=0)
    ok = torch.stack([found, found & ~cont], 1).view(-1)
    run = torch.stack([run, run], 1).view(-1)
    # order it by (run, key bytes 4-7, key bytes 8-9, position): two
    # stable sorts, the second on a key of 53 bits or the unused mark
    word01 = u32.widen(flat_rows[:, :TAIL_WORDS].index_select(0, pos))
    low = ((word01[:, 1] >> 16) - (1 << 15)).to(torch.int16)
    by_low = torch.sort(low, stable=True).indices
    lead = torch.where(ok, (run << 32) | word01[:, 0], 1 << 62)
    order = by_low.index_select(
        0, torch.sort(lead.index_select(0, by_low), stable=True).indices)
    # the k-th record of the rules' order moves to the k-th buffered
    # position; entry k past the tied records repeats the move of entry
    # k mod tied, so no place is written twice with different values
    tied = ok.sum()
    slot = torch.nonzero_static(ok, size=ok.shape[0], fill_value=0)[:, 0]
    k = torch.arange(ok.shape[0], device=dev) % tied.clamp(min=1)
    src = pos.index_select(0, order.index_select(0, k))
    dst = pos.index_select(0, slot.index_select(0, k))
    flat_ids.index_copy_(0, dst, flat_ids.index_select(0, src))
    flat_rows.index_copy_(0, dst, flat_rows.index_select(0, src))
    return tied, overflow
