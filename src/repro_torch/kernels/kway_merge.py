"""Indexed k-way merge — the reduce-side emit-window merge on the device.

Port of src/repro/kernels/kway_merge.py. The reduce task streams bounded
chunk windows of each spilled run and merges one window per emit cycle;
`merge_fragments_device` is the drop-in for shuffle/runtime's numpy
`merge_fragments`, bit-identical to it on any input. Each record carries
three operands:

  keys: uint32   vals: uint32   idx: int32 (window ordinal)

and every merge compares LEXICOGRAPHICALLY on (key, val, idx). Because
idx is the record's position in the concatenated fragment window, the
triple order is exactly the stable argsort order of the packed
(key<<32|val) keys, and idx doubles as the gather index for the host-side
payload rows. Pads are (0xFFFFFFFF, 0xFFFFFFFF, total): real records equal
to the pad key/val still sort before them.

`merge_sorted_pairs_indexed` (one tournament round) has two versions:

  * the CUDA kernel, csrc/kway_merge.cu — a merge path on the triple order
    (replaces the TPU kernel's bitonic network);
  * the plain version — the reference's network: a ++ reversed(b), one
    ascending merge pass, compare-exchanges on (packed key/val, idx).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build, u32
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ops import PAD_KEY, PAD_VAL, next_pow2


def _compare_exchange_idx(packed, idx, dist: int, window: int):
    """One bitonic substage on (packed (rows, B) int64, idx (rows, B)
    int64), comparing (packed, idx) lexicographically."""
    rows, b = packed.shape
    groups = b // (2 * dist)
    pr = packed.reshape(rows, groups, 2, dist)
    ir = idx.reshape(rows, groups, 2, dist)
    p0, p1, i0, i1 = pr[:, :, 0], pr[:, :, 1], ir[:, :, 0], ir[:, :, 1]
    g = torch.arange(groups, device=packed.device)
    asc = ((g * (2 * dist)) // window % 2 == 0).view(1, groups, 1)
    swap = (p0 > p1) | ((p0 == p1) & (i0 > i1))
    do = torch.where(asc, swap, ~swap)

    def weave(a0, a1):
        return torch.stack([torch.where(do, a1, a0), torch.where(do, a0, a1)],
                           dim=2).reshape(rows, b)

    return weave(p0, p1), weave(i0, i1)


def merge_sorted_pairs_indexed_plain(a_keys, a_vals, a_idx,
                                     b_keys, b_vals, b_idx):
    """The plain torch version: bitonic merge network on triples."""
    packed = torch.cat([u32.pack(a_keys, a_vals),
                        u32.pack(b_keys, b_vals).flip(-1)], dim=-1)
    idx = torch.cat([a_idx.to(torch.int64), b_idx.to(torch.int64).flip(-1)],
                    dim=-1)
    b = packed.shape[-1]
    dist = b // 2
    while dist >= 1:
        packed, idx = _compare_exchange_idx(packed, idx, dist, b)
        dist //= 2
    mk, mv = u32.unpack(packed)
    return mk, mv, idx.to(torch.int32)


def merge_sorted_pairs_indexed(a_keys, a_vals, a_idx, b_keys, b_vals, b_idx):
    """Merge row i of a_* with row i of b_* (each (n, L), rows sorted on
    (key, val, idx); keys/vals u32 tensors, idx int32). Returns (keys,
    vals, idx) of shape (n, 2L). L a power of two. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    ts = (a_keys, a_vals, a_idx, b_keys, b_vals, b_idx)
    if a_keys.ndim != 2 or any(t.shape != a_keys.shape for t in ts):
        raise ValueError("merge_sorted_pairs_indexed needs six equal (n, L)")
    n, run = a_keys.shape
    if run & (run - 1):
        raise ValueError(f"run length {run} must be a power of two")
    if a_keys.device.type == "cpu":
        return merge_sorted_pairs_indexed_plain(*ts)
    u32.require_u32(*ts)
    ok = torch.empty((n, 2 * run), dtype=torch.int32, device=a_keys.device)
    ov, oi = torch.empty_like(ok), torch.empty_like(ok)
    _build.launch("kway_merge", *ts, ok, ov, oi, n, run)
    _build.count_launch(merge_sorted_pairs_indexed)
    return ok, ov, oi


merge_sorted_pairs_indexed.launches = 0


def kway_merge_indexed(keys, vals, idx, *, impl: str = "kernel"):
    """Merge K triple-lex-sorted runs -> one sorted run of K*L triples.

    keys, vals: (K, L) u32 tensors; idx: (K, L) int32. K and L powers of
    two. impl "kernel" runs the pairwise tournament (kernel on CUDA,
    plain network on CPU); "ref" the torch sort oracle.
    """
    k = keys.shape[0]
    assert k & (k - 1) == 0, "K must be a power of two"
    if impl == "ref":
        mk, mv, mi = _ref.sort_kvi_ref(keys.reshape(1, -1),
                                       vals.reshape(1, -1),
                                       idx.reshape(1, -1))
        return mk.reshape(-1), mv.reshape(-1), mi.reshape(-1)
    if impl != "kernel":
        raise ValueError(f"impl={impl!r}: must be 'kernel' or 'ref'")
    while k > 1:
        keys, vals, idx = merge_sorted_pairs_indexed(
            keys[0::2].contiguous(), vals[0::2].contiguous(),
            idx[0::2].contiguous(), keys[1::2].contiguous(),
            vals[1::2].contiguous(), idx[1::2].contiguous())
        k //= 2
    return keys.reshape(-1), vals.reshape(-1), idx.reshape(-1)


def _pad_window(frags, total: int):
    """Pack an emit window's fragments into (K, L) power-of-two numpy
    arrays padded with lex-max records whose ordinal is `total` (past
    every real record, so pads always sort last)."""
    kp = next_pow2(len(frags))
    lp = next_pow2(max(max(f[0].size for f in frags), 1))
    keys = np.full((kp, lp), PAD_KEY, np.uint32)
    vals = np.full((kp, lp), PAD_VAL, np.uint32)
    idx = np.full((kp, lp), total, np.int32)
    base = 0
    for r, f in enumerate(frags):
        n = f[0].size
        keys[r, :n] = f[0]
        vals[r, :n] = f[1]
        idx[r, :n] = np.arange(base, base + n, dtype=np.int32)
        base += n
    return keys, vals, idx


def merge_fragments_device(frags, payload_words: int, *,
                           impl: str = "kernel", device="cuda"):
    """Device-backed drop-in for shuffle/runtime.merge_fragments.

    Same contract, bit-identical output: merge already-sorted fragments
    [(keys, ids, payload, k64), ...] (numpy) into one sorted (keys, ids,
    payload) batch, ties in stable concatenation order (the ordinal
    operand). The window runs on `device`; payload rows are gathered on
    the host by the merged ordinals.
    """
    frags = [f for f in frags if f[3].size]
    if not frags:
        empty = np.empty((0,), np.uint32)
        pw = int(payload_words)
        return empty, empty, (np.empty((0, pw), np.uint32) if pw else None)
    if len(frags) == 1:
        k, i, p, _ = frags[0]
        return k, i, p
    total = sum(f[0].size for f in frags)
    assert total < 2**31, "emit window exceeds int32 ordinal range"
    keys, vals, idx = _pad_window(frags, total)
    mk, mv, mi = kway_merge_indexed(u32.from_numpy(keys, device),
                                    u32.from_numpy(vals, device),
                                    torch.from_numpy(idx).to(device),
                                    impl=impl)
    mk = u32.to_numpy(mk[:total])
    mv = u32.to_numpy(mv[:total])
    payload = None
    if payload_words:
        mi = mi[:total].cpu().numpy()
        payload = np.concatenate([f[2] for f in frags])[mi]
    return mk, mv, payload


__all__ = [
    "kway_merge_indexed",
    "merge_fragments_device",
    "merge_sorted_pairs_indexed",
]
