"""Chunked gated linear attention — the shared recurrence engine.

Twin of src/repro/models/ssm.py, in plain torch ops (the reference is
`jnp` code, not a Pallas kernel). xLSTM's mLSTM (matrix memory +
normalizer) and hymba's Mamba2-style SSD heads are instances of one
recurrence over per-head state S (dk, dv):

    S_t = exp(a_t) * S_{t-1} + exp(b_t) * k_t v_t^T      (a_t, b_t <= 0)
    y_t = q_t @ S_t            [ / max(|q_t . n_t|, 1) with normalizer n ]

Training/prefill uses the chunkwise-parallel form (a loop over chunks of
length `chunk`, two matmuls inside each); decode is the O(1)-state
single step. Every gate is in log space and <= 0, so every exponent in
the chunked form is <= 0: no overflow without a running-max stabilizer
(the masked upper triangle of a chunk's decay tile is masked before its
exp, so its gradient stays finite too).
With gradients on, each chunk step is recomputed in the backward pass
(torch.utils.checkpoint, the twin of the reference's jax.checkpoint), so
the (c, c) decay tiles are not all kept.

Shapes: q, k (B, H, T, dk); v (B, H, T, dv); a, b (B, H, T).
State: S (B, H, dk, dv); n (B, H, dk).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_step(s, n, qc, kc, vc, ac, bc, tril, normalize: bool):
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    f = torch.cumsum(ac, dim=-1)  # (B,H,c) inclusive log-decay
    # intra-chunk: D[t,s] = exp(F_t - F_s + b_s), s <= t (exponent <= 0).
    # The exponent is masked before the exp: above the diagonal it is
    # positive and overflows over a long chunk, and the reference's
    # where(tril, exp(logd), 0) then has a NaN gradient (0 * inf;
    # ROADMAP.md §3 fault 7). The values are the same.
    logd = f[..., :, None] - f[..., None, :] + bc[..., None, :]
    d = torch.exp(logd.masked_fill(~tril, float("-inf")))
    qk = torch.einsum("bhtd,bhsd->bhts", qf, kf)
    y = torch.einsum("bhts,bhsv->bhtv", qk * d, vf)
    # inter-chunk: the carried state
    ef = torch.exp(f)
    y = y + ef[..., None] * torch.einsum("bhtd,bhdv->bhtv", qf, s)
    if normalize:
        den = ef * torch.einsum("bhtd,bhd->bht", qf, n) + (qk * d).sum(-1)
        y = y / torch.clamp(den.abs(), min=1.0)[..., None]
    # state update: w_s = exp(F_end - F_s + b_s)
    w = torch.exp(f[..., -1:] - f + bc)
    decay = torch.exp(f[..., -1])
    s_new = decay[..., None, None] * s + torch.einsum(
        "bhs,bhsd,bhsv->bhdv", w, kf, vf)
    n_new = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", w, kf)
    return s_new, n_new, y


def gla_chunked(q, k, v, a, b, *, chunk: int = 256, normalize: bool = False,
                initial_state=None):
    """Returns (y (B, H, T, dv) in v.dtype, (S, n) final state, float32)."""
    bb, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    pad = -t % c
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        a = F.pad(a, (0, pad))  # pad decay 0 = keep state
        b = F.pad(b, (0, pad), value=-1e30)  # pad input gate 0
    nc = (t + pad) // c
    dev = q.device
    if initial_state is not None:
        s, n = initial_state
    else:
        s = torch.zeros((bb, h, dk, dv), dtype=torch.float32, device=dev)
        n = torch.zeros((bb, h, dk), dtype=torch.float32, device=dev)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v, a, b))
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        args = (s, n, q[:, :, sl], k[:, :, sl], v[:, :, sl], a[:, :, sl],
                b[:, :, sl], tril, normalize)
        if remat:
            s, n, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            s, n, y = _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=2)[:, :, :t]
    return y.to(v.dtype), (s, n)


def gla_step(q, k, v, a, b, state, *, normalize: bool = False):
    """Single decode step. q/k (B,H,dk); v (B,H,dv); a/b (B,H) log gates.

    Returns (y (B,H,dv), (S, n) updated state).
    """
    s, n = state
    qf, kf, vf = q.float(), k.float(), v.float()
    ea = torch.exp(a)[..., None, None]
    eb = torch.exp(b)[..., None, None]
    s_new = ea * s + eb * kf[..., :, None] * vf[..., None, :]
    n_new = ea[..., 0] * n + eb[..., 0] * kf
    y = torch.einsum("bhd,bhdv->bhv", qf, s_new)
    if normalize:
        den = torch.einsum("bhd,bhd->bh", qf, n_new)
        y = y / torch.clamp(den.abs(), min=1.0)[..., None]
    return y.to(v.dtype), (s_new, n_new)


def causal_conv1d(x, kernel, *, state=None):
    """Depthwise causal conv. x (B, T, D); kernel (K, D).

    state (B, K-1, D) holds the trailing inputs from the previous segment.
    Returns (y (B, T, D), new_state (B, K-1, D)).
    """
    kk = kernel.shape[0]
    bsz, t, dim = x.shape
    if state is None:
        state = torch.zeros((bsz, kk - 1, dim), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state.to(x.dtype), x], dim=1)  # (B, T+K-1, D)
    y = sum(xx[:, i:i + t] * kernel[i].to(x.dtype) for i in range(kk))
    new_state = xx[:, -(kk - 1):] if kk > 1 else state
    return y, new_state
