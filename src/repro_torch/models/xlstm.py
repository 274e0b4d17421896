"""xLSTM (arXiv:2405.04517): mLSTM + sLSTM blocks, no FFN (xlstm-125m).

Twin of src/repro/models/xlstm.py. mLSTM blocks use the chunkwise-
parallel matrix-memory recurrence (models/ssm.py with the normalizer),
O(1) state per head. sLSTM blocks (scalar memory, block-diagonal
recurrent gate mixing) are sequential: a Python loop over time here, the
reference's `lax.scan`. Layers `slstm_layers` (5 and 11 of 12) are
sLSTM, the rest mLSTM.

Input/forget gates are log-sigmoids (<= 0), as in the reference, so the
chunked engine needs no stabilizer. The layers differ in kind, so the
model holds them as a list (`blocks.<i>.<key>`, one reference leaf per
layer and key: nothing is stacked) and loops over them; the cache is a
list too, per layer {"c", "n", "h"} (sLSTM, (B, d) float32) or {"s",
"n", "conv"} (mLSTM: (B, H, dh, dh) and (B, H, dh) float32, the conv
tail (B, K-1, 2d) in the compute dtype), O(1) in the sequence length.
`decode_step` is position-free.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import causal_conv1d, gla_chunked, gla_step
from repro_torch.models.transformer import param_dtype

SLSTM_DEFAULT = (5, 11)


def slstm_layers(cfg: ArchConfig):
    return tuple(i for i in SLSTM_DEFAULT if i < cfg.n_layers)


def mlstm_init(cfg: ArchConfig, generator, dtype):
    d = cfg.d_model
    di = 2 * d  # up-projection factor 2
    h = cfg.n_heads

    def u(shape, scale=None):
        return layers.uniform_init(shape, generator, scale, dtype=dtype)

    dev = layers._device(generator)
    return {
        "ln": layers.rmsnorm_init(d, generator, dtype),
        "w_up": u((d, di)),
        "w_z": u((d, di)),
        "conv": u((cfg.ssm_conv, di), 0.3),
        "wq": u((di, di)),
        "wk": u((di, di)),
        "wv": u((di, di)),
        "w_gates": u((di, 2 * h), di**-0.5),
        # forget-gate bias ~2: long memory at init
        "b_gates": torch.cat([torch.zeros((h,), dtype=dtype, device=dev),
                              torch.full((h,), 2.0, dtype=dtype,
                                         device=dev)]),
        "gn": layers.rmsnorm_init(di, generator, dtype),
        "w_down": u((di, d)),
    }


def slstm_init(cfg: ArchConfig, generator, dtype):
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "ln": layers.rmsnorm_init(d, generator, dtype),
        "w_gates": layers.uniform_init((d, 4 * d), generator,
                                       dtype=dtype),  # i, f, z, o
        "r_gates": layers.uniform_init((4, h, dh, dh), generator, dh**-0.5,
                                       dtype=dtype),
        "b_gates": torch.zeros((4 * d,), dtype=dtype,
                               device=layers._device(generator)),
        "gn": layers.rmsnorm_init(d, generator, dtype),
        "w_out": layers.uniform_init((d, d), generator, dtype=dtype),
    }


def _mlstm_qkv(p, cfg: ArchConfig, x, conv_state=None):
    """Shared train/decode projections. x (B, T, d)."""
    dt = x.dtype
    b, t, _ = x.shape
    h = cfg.n_heads
    xn = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
    xm = xn @ p["w_up"].to(dt)
    z = xn @ p["w_z"].to(dt)
    xc, conv_state = causal_conv1d(xm, p["conv"], state=conv_state)
    xc = F.silu(xc)
    di = xm.shape[-1]
    dh = di // h

    def heads(u):
        return u.reshape(b, t, h, dh).transpose(1, 2)

    q = heads(xc @ p["wq"].to(dt))
    k = heads(xc @ p["wk"].to(dt)) * dh**-0.5
    v = heads(xm @ p["wv"].to(dt))
    gates = xc @ p["w_gates"].to(dt) + p["b_gates"].to(dt)
    i_log = F.logsigmoid(gates[..., :h].float())
    f_log = F.logsigmoid(gates[..., h:].float())
    # (B, H, T) gate layout
    return (q, k, v, i_log.transpose(1, 2), f_log.transpose(1, 2), z,
            conv_state)


def _mlstm_out(p, cfg, x, y, z):
    """y (B, T, 2d) from the recurrence -> the block's output x + out."""
    y = layers.rmsnorm(p["gn"], y, cfg.norm_eps) * F.silu(z)
    return x + y @ p["w_down"].to(x.dtype)


def mlstm_block(p, cfg: ArchConfig, x):
    """Train/prefill. x (B, S, d) -> (x + out, (S, n) final state)."""
    b, s, d = x.shape
    q, k, v, i_log, f_log, z, _ = _mlstm_qkv(p, cfg, x)
    y, state = gla_chunked(q, k, v, f_log, i_log, chunk=cfg.chunk,
                           normalize=True)
    y = y.transpose(1, 2).reshape(b, s, 2 * d)
    return _mlstm_out(p, cfg, x, y, z), state


def mlstm_decode(p, cfg: ArchConfig, x, cache):
    """One step. x (B, 1, d); cache {"s", "n", "conv"}."""
    b, _, d = x.shape
    q, k, v, i_log, f_log, z, conv_state = _mlstm_qkv(
        p, cfg, x, conv_state=cache["conv"])
    y, (s_new, n_new) = gla_step(
        q[:, :, 0], k[:, :, 0], v[:, :, 0], f_log[:, :, 0], i_log[:, :, 0],
        (cache["s"], cache["n"]), normalize=True)
    y = y.reshape(b, 1, 2 * d)
    return _mlstm_out(p, cfg, x, y, z), {"s": s_new, "n": n_new,
                                         "conv": conv_state}


def slstm_block(p, cfg: ArchConfig, x, state=None):
    """Sequential sLSTM. x (B, S, d). state: dict(c, n, h) each (B, d)."""
    dt = x.dtype
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    xn = layers.rmsnorm(p["ln"], x, cfg.norm_eps)
    wx = xn @ p["w_gates"].to(dt) + p["b_gates"].to(dt)
    if state is None:
        state = {"c": torch.zeros((b, d), device=x.device),
                 "n": torch.ones((b, d), device=x.device),
                 "h": torch.zeros((b, d), device=x.device)}
    r = p["r_gates"].float()
    c, n, hh = (state[key].reshape(b, h, dh) for key in ("c", "n", "h"))
    ys = []
    for t in range(s):
        rec = torch.einsum("bhx,ghxy->bhgy", hh, r)  # (B, H, 4, dh)
        g = wx[:, t].float().reshape(b, h, 4, dh) + rec
        i = torch.exp(F.logsigmoid(g[..., 0, :]))
        f = torch.sigmoid(g[..., 1, :])
        zz = torch.tanh(g[..., 2, :])
        o = torch.sigmoid(g[..., 3, :])
        c = f * c + i * zz
        n = f * n + i
        hh = o * c / torch.clamp(n, min=1.0)
        ys.append(hh.reshape(b, d))
    y = torch.stack(ys, dim=1).to(dt)  # (B, S, d)
    y = layers.rmsnorm(p["gn"], y, cfg.norm_eps)
    new = {"c": c.reshape(b, d), "n": n.reshape(b, d), "h": hh.reshape(b, d)}
    return x + y @ p["w_out"].to(dt), new


class XLSTM(nn.Module):
    """Embedding (tied readout), the list of m/sLSTM blocks, the final
    norm. Serving or training parameters as transformer.Transformer."""

    stacked = ()  # no stacked leaves in the reference's tree

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype(cfg, trainable)
        self.sset = set(slstm_layers(cfg))
        self.embed = layers.Params(layers.embedding_init(
            cfg.padded_vocab, cfg.d_model, generator, dt), trainable)
        self.blocks = nn.ModuleList(
            layers.Params((slstm_init if i in self.sset else mlstm_init)(
                cfg, generator, dt), trainable)
            for i in range(cfg.n_layers))
        self.ln_f = layers.Params(layers.rmsnorm_init(cfg.d_model, generator,
                                                      dt), trainable)

    def _readout(self, x):
        x = layers.rmsnorm(self.ln_f, x, self.cfg.norm_eps)
        return layers.unembed(self.embed, x)

    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, padded vocab) float32."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        for i, bp in enumerate(self.blocks):
            block = slstm_block if i in self.sset else mlstm_block
            x, _ = block(bp, cfg, x)
        return self._readout(x)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int | None = None):
        """Run the prompt; returns (last-position logits, cache)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        x = layers.embed(self.embed, tokens, dt)
        caches = []
        for i, bp in enumerate(self.blocks):
            if i in self.sset:
                x, st = slstm_block(bp, cfg, x)
                caches.append(st)
                continue
            # carry the conv tail and the final (S, n)
            xin = x
            x, (s_f, n_f) = mlstm_block(bp, cfg, x)
            xn = layers.rmsnorm(bp["ln"], xin, cfg.norm_eps)
            tail = (xn @ bp["w_up"].to(dt))[:, -(cfg.ssm_conv - 1):]
            pad = cfg.ssm_conv - 1 - tail.shape[1]
            if pad:
                tail = F.pad(tail, (0, 0, pad, 0))
            caches.append({"s": s_f, "n": n_f, "conv": tail})
        return self._readout(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One step; recurrent, so `pos` is unused. Returns (logits (B, 1,
        vocab) float32, the new cache)."""
        del pos
        cfg = self.cfg
        x = layers.embed(self.embed, token, cfg.compute_dtype)
        new = []
        for i, bp in enumerate(self.blocks):
            if i in self.sset:
                x, st = slstm_block(bp, cfg, x, state=cache[i])
            else:
                x, st = mlstm_decode(bp, cfg, x, cache[i])
            new.append(st)
        return self._readout(x), new


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """Recurrent state, O(1) in max_len."""
    del max_len
    d = cfg.d_model
    h = cfg.n_heads
    di = 2 * d
    dh = di // h
    sset = set(slstm_layers(cfg))
    caches = []
    for i in range(cfg.n_layers):
        if i in sset:
            caches.append({
                "c": torch.zeros((batch, d), device=device),
                "n": torch.ones((batch, d), device=device),
                "h": torch.zeros((batch, d), device=device),
            })
        else:
            caches.append({
                "s": torch.zeros((batch, h, dh, dh), device=device),
                "n": torch.zeros((batch, h, dh), device=device),
                "conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                    dtype=cfg.compute_dtype, device=device),
            })
    return caches
