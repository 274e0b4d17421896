"""The plain reference of the Sort Benchmark's order: 100-byte records
sorted by the whole 10-byte key, as unsigned bytes compared left to
right (as valsort checks them), ties broken by id.

Plain PyTorch on the CPU; it imports neither JAX nor any module of the
port. A record is given as the port lays it out (u32 words held as
int32 bits): `keys` holds key bytes 0-3 big-endian, `payload[:, 0]`
bytes 4-7 and the high half of `payload[:, 1]` bytes 8-9. Here the key
is taken apart into its ten bytes and the records are sorted one byte
at a time, least significant first, with stable sorts: no word of the
port's layout is compared whole.
"""
from __future__ import annotations

import torch

KEY_BYTES = 10


def key_bytes(keys: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """(N, 10) int64: the key's bytes, most significant first."""
    words = torch.stack([keys, payload[:, 0], payload[:, 1]], dim=1)
    words = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int64)
    b = (words[:, :, None] >> shifts) & 0xFF  # (N, 3, 4)
    return b.reshape(-1, 12)[:, :KEY_BYTES]


def sort_records(keys, ids, payload):
    """(keys, ids, payload) in the rules' order: by key bytes 0-9, then
    by id as an unsigned 32-bit number. The whole order, with no split:
    a sort at splitters of its own (`sample_fraction`) must give it as
    its workers' valid prefixes, concatenated in worker order."""
    order = torch.sort(ids.to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    kb = key_bytes(keys, payload)
    for j in reversed(range(KEY_BYTES)):
        step = torch.sort(kb[order, j], stable=True).indices
        order = order[step]
    return keys[order], ids[order], payload[order]


def sort_split(keys, ids, payload, num_workers: int):
    """The sorted records cut at the workers' equal ranges of the leading
    32 bits: a list of (keys, ids, payload), worker d's records those
    whose key word lies in [d * 2^32 / W, (d + 1) * 2^32 / W)."""
    sk, si, sp = sort_records(keys, ids, payload)
    word = sk.to(torch.int64) & 0xFFFFFFFF
    worker = word * num_workers >> 32
    return [(sk[worker == d], si[worker == d], sp[worker == d])
            for d in range(num_workers)]
