"""Attention: flash-style chunked softmax attention + KV-cache decode.

Twin of src/repro/models/attention.py, in plain torch ops (the reference
is `jnp` code, not a Pallas kernel). Prefill uses the same online-softmax
two-level chunking (a loop over query chunks, a loop over key chunks),
so the (Sq, Sk) score matrix never materializes; scores and the running
max/sum are float32; ragged tails are padded to a whole chunk (key pads
masked by position, query pad rows sliced off). GQA groups query heads
per KV head, so KV chunks are never expanded to query-head width.

The reference's options are here too: `window` (0 or less: full
attention), `n_sink` always-attendable leading positions (hymba's meta
tokens), `q_chunk` (0: one query chunk), `q_offset` / `k_offset` and
`causal_skip`, which visits only the chunk pairs a causal mask leaves
live — the reference's lower-triangular enumeration, with identical
results (a fully masked chunk changes no accumulator).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attn_chunk_step(acc, m, l, q, k, v, q_pos, k_pos, *, causal, window,
                     scale, k_limit=None, n_sink=0):
    """One (q-chunk, k-chunk) online-softmax update.

    q (B, cq, KV, G, dh); k/v (B, ck, KV, dh); q_pos (cq,); k_pos (ck,).
    acc (B, KV, G, cq, dh); m, l (B, KV, G, cq). Masked lanes get an
    additive NEG_INF, so exp(s - m_new) underflows to 0 exactly; a fully
    masked row (m_new == NEG_INF) is zeroed by the row_live guard.
    """
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    bias = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                       device=q.device)
    if causal:
        bias = torch.where(k_pos[None, :] <= q_pos[:, None], bias, NEG_INF)
    if window and window > 0:
        in_win = k_pos[None, :] > q_pos[:, None] - window
        if n_sink:  # always-attendable leading positions
            in_win = in_win | (k_pos < n_sink)[None, :]
        bias = torch.where(in_win, bias, NEG_INF)
    if k_limit is not None:  # ragged-tail key padding
        bias = torch.where((k_pos < k_limit)[None, :], bias, NEG_INF)
    s = s + bias

    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
    row_live = (m_new > NEG_INF / 2)[..., None]
    p = torch.exp(s - torch.where(row_live, m_new[..., None], 0.0))
    p = p * row_live
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v).float()
    acc_new = acc * alpha[..., None] + pv
    return acc_new, m_new, l_new


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    chunk: int = 512, q_chunk: int | None = None,
                    q_offset: int = 0, k_offset: int = 0,
                    causal_skip: bool = False, n_sink: int = 0,
                    _k_limit=None):
    """q (B, Sq, H, dh); k, v (B, Sk, KV, dh); H % KV == 0. Query and key
    positions start at `q_offset` and `k_offset`. Key chunks of `chunk`
    positions; query chunks of `q_chunk` (None: `chunk`; 0: all of Sq in
    one). `window` > 0 keeps the keys within `window` positions of the
    query, and the first `n_sink` positions always. Returns (B, Sq, H,
    dv) in q.dtype.
    """
    b, sq, h, dh = q.shape
    _, sk, kv, _ = k.shape
    dv = v.shape[-1]
    g = h // kv
    scale = dh**-0.5
    cq = sq if q_chunk == 0 else min(q_chunk or chunk, sq)
    ck = min(chunk, sk)
    # Pad ragged tails to a whole chunk; key pads get an out-of-range
    # position (masked by k_limit), query pad rows are sliced off.
    sq_pad = -sq % cq
    sk_pad = -sk % ck
    if sq_pad or sk_pad:
        qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad))
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_pad))
        out = flash_attention(qp, kp, vp, causal=causal, window=window,
                              chunk=chunk, q_chunk=q_chunk,
                              q_offset=q_offset, k_offset=k_offset,
                              causal_skip=causal_skip, n_sink=n_sink,
                              _k_limit=k_offset + sk)
        return out[:, :sq]
    nq, nk = sq // cq, sk // ck

    qg = q.reshape(b, nq, cq, kv, g, dh)
    ks = k.reshape(b, nk, ck, kv, dh)
    vs = v.reshape(b, nk, ck, kv, dv)
    q_positions = q_offset + torch.arange(sq, device=q.device)
    k_positions = k_offset + torch.arange(sk, device=q.device)
    skip = causal_skip and causal

    outs = []
    for qi in range(nq):
        qp = q_positions[qi * cq:(qi + 1) * cq]
        acc = torch.zeros((b, kv, g, cq, dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kv, g, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kv, g, cq), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            if skip and k_offset + ki * ck > q_offset + (qi + 1) * cq - 1:
                break  # this and every later key chunk is in the future
            acc, m, l = _attn_chunk_step(
                acc, m, l, qg[:, qi], ks[:, ki], vs[:, ki], qp,
                k_positions[ki * ck:(ki + 1) * ck], causal=causal,
                window=window, scale=scale, k_limit=_k_limit, n_sink=n_sink)
        out = acc / l.clamp_min(1e-30)[..., None]  # (B, KV, G, cq, dv)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, cq, KV, G, dv)
    out = torch.stack(outs, dim=1).reshape(b, sq, h, dv)
    return out.to(q.dtype)


def decode_attention(q, cache_k, cache_v, *, cache_len: int,
                     window: int = 0):
    """Single-step attention against a KV cache.

    q (B, 1, H, dh); cache_k/v (B, L, KV, dh); cache_len = number of valid
    entries. For ring-buffer (windowed) caches, all L slots are valid once
    cache_len >= L. Returns (B, 1, H, dh).
    """
    b, _, h, dh = q.shape
    _, lcache, kv, _ = cache_k.shape
    dv = cache_v.shape[-1]
    g = h // kv
    scale = dh**-0.5
    qg = q.reshape(b, kv, g, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k).float() * scale
    idx = torch.arange(lcache, device=q.device)
    limit = min(cache_len, window) if window else cache_len
    s = torch.where((idx < limit)[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(b, 1, h, dv).to(q.dtype)
