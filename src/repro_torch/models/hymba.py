"""Hymba (arXiv:2411.13676): hybrid-head blocks, parallel attention + SSM.

Twin of src/repro/models/hymba.py. Each block runs GQA attention heads
and Mamba2-style SSD heads (models/ssm.py) in parallel on the same
input, fuses the branch outputs (per-branch RMSNorm and learnable scalar
betas, averaged), then a SwiGLU FFN. Sliding-window attention everywhere
except `global_layers` (full attention), plus `meta_tokens` learnable
prefix tokens that are always attendable (`n_sink`).

The reference pads the SSM heads up to `ssm_pad_heads` (25 -> 32) so that
they shard evenly over a 16-way model axis; a pad head has a zero input
gate and contributes exact zeros. One card has no model axis, so the port
runs the real heads only (tests/test_torch_models.py holds its outputs to
the padded reference).

`forward` loops over the blocks (the reference scans them, with the
per-layer window as data), with `cfg.remat` recomputing each block in the
backward pass. Caches are per layer: a full cache of `max_len + meta`
slots for a global layer, otherwise a ring of `window + meta` slots with
the meta tokens pinned at the front (text position p at slot meta +
(p - meta) % window), beside the SSD state {"s", "n"} and the conv tail.
A prompt longer than `max_len`, or a decode position past a global
layer's cache, raises (the reference would truncate the cache or clamp
the write onto its last slot).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import causal_conv1d, gla_chunked, gla_step
from repro_torch.models.transformer import param_dtype, q_chunk_of


def _ssm_heads(cfg: ArchConfig):
    d_inner = cfg.d_model  # SSM branch width = d_model
    dh = cfg.head_dim
    return d_inner // dh, dh, d_inner


def block_init(cfg: ArchConfig, generator, dtype):
    d = cfg.d_model
    n_ssm, dh, d_inner = _ssm_heads(cfg)
    dev = layers._device(generator)

    def u(shape, scale=None):
        return layers.uniform_init(shape, generator, scale, dtype=dtype)

    return {
        "ln_attn": layers.rmsnorm_init(d, generator, dtype),
        "ln_ffn": layers.rmsnorm_init(d, generator, dtype),
        "attn": layers.gqa_proj_init(d, cfg.n_heads, cfg.n_kv_heads, dh,
                                     generator, dtype),
        "ssm": {
            "w_in": u((d, 2 * d_inner)),  # x + gate
            "conv": u((cfg.ssm_conv, d_inner), 0.3),
            "w_bc": u((d_inner, 2 * cfg.ssm_state)),
            "w_dt": u((d_inner, n_ssm), d**-0.5),
            "a_log": torch.zeros((n_ssm,), dtype=dtype, device=dev),
            "d_skip": torch.ones((n_ssm,), dtype=dtype, device=dev),
            "w_out": u((d_inner, d)),
        },
        "norm_attn_out": layers.rmsnorm_init(d, generator, dtype),
        "norm_ssm_out": layers.rmsnorm_init(d, generator, dtype),
        "betas": torch.ones((2,), dtype=dtype, device=dev),
        "ffn": layers.swiglu_init(d, cfg.d_ff, generator, dtype),
    }


def layer_window(cfg: ArchConfig, i: int) -> int:
    """Layer i's attention window; 0 means full attention (global)."""
    return 0 if i in cfg.global_layers else cfg.window


def cache_slots(cfg: ArchConfig, i: int, max_len: int) -> int:
    if i in cfg.global_layers:
        return max_len + cfg.meta_tokens
    return min(cfg.window + cfg.meta_tokens, max_len + cfg.meta_tokens)


def _ssm_inputs(p, cfg: ArchConfig, xn, conv_state=None):
    """xn (B, T, d) -> the GLA inputs (q, k, v, a, b), the gate z, the
    conv output xs and the conv state."""
    dt = xn.dtype
    b, t, _ = xn.shape
    n_ssm, dh, d_inner = _ssm_heads(cfg)
    xs, z = (xn @ p["w_in"].to(dt)).chunk(2, dim=-1)
    xs, conv_state = causal_conv1d(xs, p["conv"], state=conv_state)
    xs = F.silu(xs)
    bmat, cmat = (xs @ p["w_bc"].to(dt)).chunk(2, dim=-1)  # (B, T, N)
    dt_raw = (xs @ p["w_dt"].to(dt)).float()  # (B, T, H)
    # decay a <= 0: -softplus(dt) * exp(a_log); input gate b <= 0
    a = -F.softplus(dt_raw) * torch.exp(p["a_log"].float())
    bgate = F.logsigmoid(dt_raw)
    # heads: v = head-split of xs; k = B shared across heads; q = C
    v = xs.reshape(b, t, n_ssm, dh).transpose(1, 2)  # (B, H, T, dh)
    k = bmat[:, None].expand(b, n_ssm, t, cfg.ssm_state)
    q = cmat[:, None].expand(b, n_ssm, t, cfg.ssm_state)
    return (q, k, v, a.transpose(1, 2), bgate.transpose(1, 2), z, xs,
            conv_state)


def _ssm_out(p, cfg, y, xs, z):
    """y (B, T, d_inner) of the heads -> the SSM branch's output."""
    dt = xs.dtype
    dh = cfg.head_dim
    y = y + xs * p["d_skip"].to(dt).repeat_interleave(dh)[None, None]
    return (y * F.silu(z)) @ p["w_out"].to(dt)


def _fuse(p, cfg, attn_out, ssm_out):
    bet = p["betas"].to(attn_out.dtype)
    a = layers.rmsnorm(p["norm_attn_out"], attn_out, cfg.norm_eps)
    s = layers.rmsnorm(p["norm_ssm_out"], ssm_out, cfg.norm_eps)
    return 0.5 * (bet[0] * a + bet[1] * s)


def _ffn(p, cfg, h):
    return h + layers.swiglu(p["ffn"], layers.rmsnorm(p["ln_ffn"], h,
                                                       cfg.norm_eps))


def _layer(p, cfg: ArchConfig, x, cos, sin, window: int):
    """One block over the whole sequence (meta tokens first). Returns
    (out, (k, v), (S, n) final SSD state, xn)."""
    b, t, _ = x.shape
    xn = layers.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    q, k, v = layers.qkv_project(p["attn"], xn, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim)
    q = layers.apply_rope(q, cos, sin)
    k = layers.apply_rope(k, cos, sin)
    attn_out = flash_attention(q, k, v, causal=True, window=window,
                               chunk=cfg.attn_chunk, q_chunk=q_chunk_of(cfg),
                               n_sink=cfg.meta_tokens)
    attn_out = layers.out_project(p["attn"], attn_out)
    qg, kg, vg, a, bg, z, xs, _ = _ssm_inputs(p["ssm"], cfg, xn)
    y, state = gla_chunked(qg, kg, vg, a, bg, chunk=cfg.chunk)
    y = y.transpose(1, 2).reshape(b, t, -1)
    ssm_out = _ssm_out(p["ssm"], cfg, y, xs, z)
    h = x + _fuse(p, cfg, attn_out, ssm_out)
    return _ffn(p, cfg, h), (k, v), state, xn


class Hymba(nn.Module):
    """Embedding (tied readout), the meta tokens, the blocks, the final
    norm. Serving or training parameters as transformer.Transformer."""

    stacked = ("blocks",)

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype(cfg, trainable)
        self.embed = layers.Params(layers.embedding_init(
            cfg.padded_vocab, cfg.d_model, generator, dt), trainable)
        meta = layers._empty((cfg.meta_tokens, cfg.d_model), generator, dt)
        if generator is not None:
            meta.normal_(0.0, 0.02, generator=generator)
        self.meta = nn.Parameter(meta, requires_grad=trainable)
        self.blocks = nn.ModuleList(
            layers.Params(block_init(cfg, generator, dt), trainable)
            for _ in range(cfg.n_layers))
        self.ln_f = layers.Params(layers.rmsnorm_init(cfg.d_model, generator,
                                                      dt), trainable)

    def _inputs(self, tokens):
        """The meta tokens, then the embedded text, with the rotary
        factors of their positions."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        meta = self.meta.to(x.dtype)[None].expand(x.shape[0], -1, -1)
        x = torch.cat([meta, x], dim=1)
        cos, sin = layers.rope_frequencies(
            cfg.head_dim, cfg.rope_theta,
            torch.arange(x.shape[1], device=x.device))
        return x, cos, sin

    def _readout(self, x):
        x = layers.rmsnorm(self.ln_f, x, self.cfg.norm_eps)
        return layers.unembed(self.embed, x)

    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, padded vocab) float32."""
        cfg = self.cfg
        x, cos, sin = self._inputs(tokens)
        remat = cfg.remat and torch.is_grad_enabled()
        for i, bp in enumerate(self.blocks):
            win = layer_window(cfg, i)
            if remat:
                x = checkpoint(lambda h, bp=bp, win=win: _layer(
                    bp, cfg, h, cos, sin, win)[0], x, use_reentrant=False)
            else:
                x = _layer(bp, cfg, x, cos, sin, win)[0]
        return self._readout(x[:, cfg.meta_tokens:])

    @torch.no_grad()
    def prefill(self, tokens, max_len: int | None = None):
        """Run the prompt, building the per-layer caches. `max_len` counts
        text positions (default: the prompt's). Returns (last-position
        logits (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        meta = cfg.meta_tokens
        text = tokens.shape[1]
        max_len = max_len or text
        if text > max_len:
            raise ValueError(f"a prompt of {text} tokens does not fit a "
                             f"cache of max_len {max_len}")
        x, cos, sin = self._inputs(tokens)
        b, s, _ = x.shape
        caches = []
        for i, bp in enumerate(self.blocks):
            x, (k, v), (s_f, n_f), xn = _layer(bp, cfg, x, cos, sin,
                                               layer_window(cfg, i))
            lcache = cache_slots(cfg, i, max_len)
            ck = k.new_zeros((b, lcache) + k.shape[2:])
            cv = torch.zeros_like(ck)
            if i in cfg.global_layers:
                ck[:, :s], cv[:, :s] = k, v
            else:
                # the ring: text position p at slot meta + (p - meta) % win,
                # the meta tokens pinned at the front; only the last `win`
                # positions survive, and their slots are unique
                win = lcache - meta
                keep = min(win, s - meta)
                ck[:, :meta], cv[:, :meta] = k[:, :meta], v[:, :meta]
                slots = meta + (torch.arange(s - keep, s, device=x.device)
                                - meta) % win
                ck[:, slots], cv[:, slots] = k[:, s - keep:], v[:, s - keep:]
            d_inner = _ssm_heads(cfg)[2]
            tail = (xn @ bp["ssm"]["w_in"].to(x.dtype))[
                ..., :d_inner][:, -(cfg.ssm_conv - 1):]
            pad = cfg.ssm_conv - 1 - tail.shape[1]
            if pad:
                tail = F.pad(tail, (0, 0, pad, 0))
            caches.append({"k": ck, "v": cv, "s": s_f, "n": n_f,
                           "conv": tail})
        return self._readout(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """pos: the number of text tokens already processed (the new
        token's text position). Writes the attention caches in place.
        Returns (logits (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        meta = cfg.meta_tokens
        posv = int(pos) + meta
        x = layers.embed(self.embed, token, cfg.compute_dtype)
        b = x.shape[0]
        cos, sin = layers.rope_frequencies(
            cfg.head_dim, cfg.rope_theta, torch.tensor([posv],
                                                       device=x.device))
        new = []
        for i, bp in enumerate(self.blocks):
            lc = cache[i]
            lcache = lc["k"].shape[1]
            if i in cfg.global_layers:
                if not 0 <= posv < lcache:
                    raise IndexError(f"decode position {pos} outside the "
                                     f"cache of {lcache - meta} positions")
                slot = posv
            else:  # the ring, meta tokens pinned at the front
                slot = meta + (posv - meta) % (lcache - meta)
            xn = layers.rmsnorm(bp["ln_attn"], x, cfg.norm_eps)
            q, k, v = layers.qkv_project(bp["attn"], xn, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim)
            q = layers.apply_rope(q, cos, sin)
            lc["k"][:, slot] = layers.apply_rope(k, cos, sin)[:, 0]
            lc["v"][:, slot] = v[:, 0]
            attn_out = decode_attention(q, lc["k"], lc["v"],
                                        cache_len=min(posv + 1, lcache))
            attn_out = layers.out_project(bp["attn"], attn_out)
            qg, kg, vg, a, bg, z, xs, conv = _ssm_inputs(
                bp["ssm"], cfg, xn, conv_state=lc["conv"])
            y, (s_new, n_new) = gla_step(
                qg[:, :, 0], kg[:, :, 0], vg[:, :, 0], a[:, :, 0],
                bg[:, :, 0], (lc["s"], lc["n"]))
            ssm_out = _ssm_out(bp["ssm"], cfg, y.reshape(b, 1, -1), xs, z)
            x = _ffn(bp, cfg, x + _fuse(bp, cfg, attn_out, ssm_out))
            new.append({"k": lc["k"], "v": lc["v"], "s": s_new, "n": n_new,
                        "conv": conv})
        return self._readout(x), new


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """Per layer: the SWA ring or the full cache (global), and the
    SSD/conv state."""
    n_ssm, dh, d_inner = _ssm_heads(cfg)
    dt = cfg.compute_dtype
    caches = []
    for i in range(cfg.n_layers):
        kv = (batch, cache_slots(cfg, i, max_len), cfg.n_kv_heads, dh)
        caches.append({
            "k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "s": torch.zeros((batch, n_ssm, cfg.ssm_state, dh),
                             device=device),
            "n": torch.zeros((batch, n_ssm, cfg.ssm_state), device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner), dtype=dt,
                                device=device),
        })
    return caches
