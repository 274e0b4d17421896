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

Two versions of the same merge:

  * the CUDA kernel, csrc/kway_merge.cu — all K runs of a window in one
    launch (rank and scatter on the triple order; the source says why).
    `merge_sorted_pairs_indexed`, the TPU function's counterpart, is its
    K = 2 case over n rows; `kway_merge_indexed` and the window path of
    `merge_fragments_device` launch it once per window;
  * the plain version — the reference's network: a ++ reversed(b), one
    ascending merge pass, compare-exchanges on (packed key/val, idx),
    driven as a tournament of log2 K rounds (`kway_merge_indexed_plain`).
"""
from __future__ import annotations

import threading
import time

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


def _launch(a, b, out, n: int, k: int, run: int) -> None:
    """One launch of csrc/kway_merge.cu over n rows of K runs of `run`
    records: runs 0..K/2-1 of each row in the tensors of `a` (keys, vals,
    idx; n * K/2 runs apiece), the rest in those of `b`. Row i of the
    three (n, m) `out` tensors gets the row's first m merged records."""
    u32.require_u32(*a, *b, *out)
    _build.launch("kway_merge", *a, *b, *out, n, k, run, out[0].shape[-1])
    _build.count_launch(merge_sorted_pairs_indexed)


def merge_sorted_pairs_indexed(a_keys, a_vals, a_idx, b_keys, b_vals, b_idx):
    """Merge row i of a_* with row i of b_* (each (n, L), rows sorted on
    (key, val, idx); keys/vals u32 tensors, idx int32). Returns (keys,
    vals, idx) of shape (n, 2L). L a power of two. CPU tensors take the
    plain version, CUDA tensors the kernel (K = 2)."""
    ts = (a_keys, a_vals, a_idx, b_keys, b_vals, b_idx)
    if a_keys.ndim != 2 or any(t.shape != a_keys.shape for t in ts):
        raise ValueError("merge_sorted_pairs_indexed needs six equal (n, L)")
    n, run = a_keys.shape
    if run & (run - 1):
        raise ValueError(f"run length {run} must be a power of two")
    if a_keys.device.type == "cpu":
        return merge_sorted_pairs_indexed_plain(*ts)
    out = torch.empty((3, n, 2 * run), dtype=torch.int32,
                      device=a_keys.device)
    if out.numel():
        _launch(ts[:3], ts[3:], tuple(out), n, 2, run)
    return out[0], out[1], out[2]


merge_sorted_pairs_indexed.launches = 0


def kway_merge_indexed_plain(keys, vals, idx):
    """The plain version: log2 K rounds of the pairwise network."""
    k = keys.shape[0]
    while k > 1:
        keys, vals, idx = merge_sorted_pairs_indexed_plain(
            keys[0::2], vals[0::2], idx[0::2],
            keys[1::2], vals[1::2], idx[1::2])
        k //= 2
    return keys.reshape(-1), vals.reshape(-1), idx.reshape(-1)


def _merge_window(keys, vals, idx, out) -> None:
    """Merge the K >= 2 runs of one (K, L) window on the card into `out`
    (3, m): its first m merged keys, vals and idx. One launch."""
    half = keys.shape[0] // 2
    _launch((keys[:half], vals[:half], idx[:half]),
            (keys[half:], vals[half:], idx[half:]),
            (out[0:1], out[1:2], out[2:3]), 1, keys.shape[0], keys.shape[1])


def kway_merge_indexed(keys, vals, idx, *, impl: str = "kernel"):
    """Merge K triple-lex-sorted runs -> one sorted run of K*L triples.

    keys, vals: (K, L) u32 tensors; idx: (K, L) int32. K and L powers of
    two. impl "kernel": one kernel launch for a CUDA tensor (none for K =
    1), the plain tournament for a CPU tensor; "ref" the torch sort
    oracle.
    """
    k, run = keys.shape
    assert k & (k - 1) == 0, "K must be a power of two"
    assert run & (run - 1) == 0, "L must be a power of two"
    if impl == "ref":
        mk, mv, mi = _ref.sort_kvi_ref(keys.reshape(1, -1),
                                       vals.reshape(1, -1),
                                       idx.reshape(1, -1))
        return mk.reshape(-1), mv.reshape(-1), mi.reshape(-1)
    if impl != "kernel":
        raise ValueError(f"impl={impl!r}: must be 'kernel' or 'ref'")
    if keys.device.type == "cpu":
        return kway_merge_indexed_plain(keys, vals, idx)
    if k == 1:
        return keys.reshape(-1), vals.reshape(-1), idx.reshape(-1)
    out = torch.empty((3, k * run), dtype=torch.int32, device=keys.device)
    _merge_window(keys.contiguous(), vals.contiguous(), idx.contiguous(),
                  out)
    return out[0], out[1], out[2]


def _window_shape(frags) -> tuple[int, int]:
    """(K, L) of the padded window: powers of two over the fragments."""
    return (next_pow2(len(frags)),
            next_pow2(max(max(f[0].size for f in frags), 1)))


def _pad_window(frags, total: int, out=None):
    """Pack an emit window's fragments into (K, L) power-of-two numpy
    arrays padded with lex-max records whose ordinal is `total` (past
    every real record, so pads always sort last). `out`, an int32 (3, K,
    L) array, receives them in place (keys, vals as uint32 bits)."""
    kp, lp = _window_shape(frags)
    if out is None:
        out = np.empty((3, kp, lp), np.int32)
    keys, vals, idx = out[0].view(np.uint32), out[1].view(np.uint32), out[2]
    keys.fill(PAD_KEY)
    vals.fill(PAD_VAL)
    idx.fill(total)
    base = 0
    for r, f in enumerate(frags):
        n = f[0].size
        keys[r, :n] = f[0]
        vals[r, :n] = f[1]
        idx[r, :n] = np.arange(base, base + n, dtype=np.int32)
        base += n
    return keys, vals, idx


_staging = threading.local()


def _pinned(dev: torch.device, n_in: int, n_out: int):
    """This thread's page-locked host buffers for windows on `dev`: int32,
    at least n_in and n_out long. They grow in powers of two and are kept
    for the thread's next window, so a window allocates nothing pinned."""
    bufs = _staging.__dict__.setdefault("bufs", {})
    have = bufs.get(dev)
    if have is None or have[0].numel() < n_in or have[1].numel() < n_out:
        sizes = (n_in, n_out) if have is None else (
            max(n_in, have[0].numel()), max(n_out, have[1].numel()))
        have = bufs[dev] = tuple(
            torch.empty(next_pow2(n), dtype=torch.int32, pin_memory=True)
            for n in sizes)
    return have[0][:n_in], have[1][:n_out]


def merge_fragments_device(frags, payload_words: int, *,
                           impl: str = "kernel", device="cuda", split=None):
    """Device-backed drop-in for shuffle/runtime.merge_fragments.

    Same contract, bit-identical output: merge already-sorted fragments
    [(keys, ids, payload, k64), ...] (numpy) into one sorted (keys, ids,
    payload) batch, ties in stable concatenation order (the ordinal
    operand). The window runs on `device`; payload rows are gathered on
    the host by the merged ordinals.

    On a card with impl "kernel" a window costs one copy each way through
    this thread's pinned buffers, one launch and one synchronise. A dict
    `split` receives the host µs of each step ("pad", "h2d", "kernel",
    "d2h", "gather"), the card synchronised after each; it is for
    measurement and slows the call. Windows that need a merge are counted
    in `merge_fragments_device.windows` and their records in `.records`.
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
    _build.count_launch(merge_fragments_device, "windows")
    _build.count_launch(merge_fragments_device, "records", total)
    dev = torch.device(device)
    t = time.perf_counter()

    def lap(step):
        nonlocal t
        if split is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            split[step] = (now - t) * 1e6
            t = now

    if dev.type == "cuda" and impl == "kernel":
        kp, lp = _window_shape(frags)
        host_in, host_out = _pinned(dev, 3 * kp * lp, 3 * total)
        _pad_window(frags, total, out=host_in.numpy().reshape(3, kp, lp))
        lap("pad")
        win = torch.empty((3, kp, lp), dtype=torch.int32, device=dev)
        win.copy_(host_in.view(3, kp, lp), non_blocking=True)
        lap("h2d")
        out = torch.empty((3, total), dtype=torch.int32, device=dev)
        _merge_window(win[0], win[1], win[2], out)
        lap("kernel")
        host_out.view(3, total).copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        merged = host_out.numpy().reshape(3, total).copy()
        lap("d2h")
        mk, mv, mi = (merged[0].view(np.uint32), merged[1].view(np.uint32),
                      merged[2])
    else:
        keys, vals, idx = _pad_window(frags, total)
        lap("pad")
        mk, mv, mi = kway_merge_indexed(u32.from_numpy(keys, dev),
                                        u32.from_numpy(vals, dev),
                                        torch.from_numpy(idx).to(dev),
                                        impl=impl)
        mk = u32.to_numpy(mk[:total])
        mv = u32.to_numpy(mv[:total])
        mi = mi[:total].cpu().numpy() if payload_words else None
        lap("kernel")
    payload = None
    if payload_words:
        payload = np.concatenate([f[2] for f in frags])[mi]
    lap("gather")
    return mk, mv, payload


merge_fragments_device.windows = 0
merge_fragments_device.records = 0


__all__ = [
    "kway_merge_indexed",
    "merge_fragments_device",
    "merge_sorted_pairs_indexed",
]
