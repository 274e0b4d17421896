"""The key-tail stage on the card: each run of equal key words ordered by
key bytes 4-9 and its ids and payload rows moved once, in place
(core/keytail.order_key_tails, which checks the inputs, and whose plain
version is the aten composition this replaces).

Replaces no TPU kernel: the reference sorts a 4-byte key and has no
key-tail stage. The CUDA source, csrc/key_tail.cu, says what bounds it and
how its classes of run length answer that: runs of up to 32 records are
ordered by the warp that finds them (key_tail_find), longer ones are
listed on the card and ordered by one block each (key_tail_order: the mid
class, then the large class). A call is a memset and three launches.

The C side sizes the lists and scratch (rt_key_tail_sizes): under a fixed
`capacity` of pairs from it, with no host wait; with `capacity` None
(sampled splitters) the lists take their largest size, and the large
class's scratch is sized from the words it needs, read on the host once a
call while the mid class runs on the card. A run that the lists or the
scratch cannot hold sets `overflow`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

TIED, SCRATCH, MOVED = 0, 2, 3  # csrc/key_tail.cu's counts in `state`


def sizes(slots: int, pw: int, capacity: int | None):
    """(state counts, mid list entries, large list entries, scratch
    words or None where counted on the card) of a call over
    `slots` places, from rt_key_tail_sizes. Raises ValueError on a pw the
    kernels do not take."""
    out = (ctypes.c_longlong * 5)()
    if _build.function("key_tail_sizes")(
            slots, pw, -1 if capacity is None else capacity, out):
        raise ValueError(f"pw {pw}: the kernel takes 2 to {out[4]} payload "
                         "words (a run of the mid class stages its rows in "
                         "one block's shared memory)")
    return out[0], out[1], out[2], None if out[3] < 0 else out[3]


def order_key_tails(keys: torch.Tensor, ids: torch.Tensor,
                    rows: torch.Tensor, valid: torch.Tensor,
                    capacity: int | None):
    """core/keytail.order_key_tails on CUDA tensors it has checked: the
    same arguments and in-place result, bit-identical to the plain version
    wherever that does not overflow. Returns (tied, overflow, moved) on the
    card: `moved` counts the records whose place changed. Under overflow
    `tied` counts every run's records (the plain version those of the
    first `capacity` pairs) and the order is unspecified, as there. Raises
    on tensors off the card and on a pw the kernel does not take."""
    if keys.device.type != "cuda":
        raise ValueError(f"tensors on {keys.device}: the kernel takes CUDA "
                         "tensors (core/keytail.order_key_tails takes CPU "
                         "ones to the plain version)")
    wl, m = keys.shape
    pw = rows.shape[-1]
    dev = keys.device
    slots = wl * m
    state_len, cap_mid, cap_large, words = sizes(slots, pw, capacity)
    state = torch.empty(state_len, dtype=torch.int64, device=dev)
    mid = torch.empty((cap_mid, 2), dtype=torch.int64, device=dev)
    large = torch.empty((cap_large, 2), dtype=torch.int64, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    cap = -1 if capacity is None else capacity
    stage = (keys, ids, rows, valid, state, mid, large, wl, m, pw, cap_mid,
             cap_large)
    _build.launch("key_tail_find", *stage)
    if capacity is None:
        host = torch.empty(1, dtype=torch.int64, pin_memory=True)
        host.copy_(state[SCRATCH:SCRATCH + 1], non_blocking=True)
        counted = torch.cuda.Event()
        counted.record(torch.cuda.current_stream(dev))
    _build.launch("key_tail_order", *stage, cap, overflow, 0, 0, 0)
    if capacity is None:
        counted.synchronize()
        words = int(host[0])
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    _build.launch("key_tail_order", *stage, cap, overflow,
                  scratch if words else 0, words, 1)
    _build.count_launch(order_key_tails, shape=(slots, pw))
    return state[TIED], overflow, state[MOVED]


order_key_tails.launches = 0  # calls, each its three launches
order_key_tails.shapes = set()  # (slots S = Wl * M, pw) launched at
