"""Whisper-style encoder-decoder backbone (whisper-base).

Twin of src/repro/models/whisper.py. The conv/mel frontend is a stub:
the caller supplies frame embeddings (B, enc_len, d) directly. Encoder:
bidirectional self-attention blocks; decoder: causal self-attention,
cross-attention to the encoder, GELU MLPs (the reference's
jax.nn.gelu, the tanh approximation). RoPE on both sides, as the
reference. A sequence of S text positions maps to `enc_len_for(cfg, S)`
= max(S // 4, 8) frames.

The cache is {"k", "v": (L, B, max_len, KV, dh)} for the decoder's self-
attention and {"xk", "xv": (L, B, enc_len, KV, dh)} for the cross-
attention, computed once in `prefill`; `decode_step` attends the whole
encoder length and writes position `pos` in place (outside the cache it
raises).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import param_dtype


def enc_len_for(cfg: ArchConfig, seq_len: int) -> int:
    return max(seq_len // 4, 8)


def _gelu_mlp_init(d, ff, generator, dtype):
    return {"w1": layers.uniform_init((d, ff), generator, dtype=dtype),
            "w2": layers.uniform_init((ff, d), generator, dtype=dtype)}


def _gelu_mlp(p, x):
    dt = x.dtype
    return F.gelu(x @ p["w1"].to(dt), approximate="tanh") @ p["w2"].to(dt)


def _attn_init(cfg, generator, dtype):
    return layers.gqa_proj_init(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, generator, dtype)


def enc_block_init(cfg: ArchConfig, generator, dtype):
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, generator, dtype),
        "attn": _attn_init(cfg, generator, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, generator, dtype),
        "mlp": _gelu_mlp_init(cfg.d_model, cfg.d_ff, generator, dtype),
    }


def dec_block_init(cfg: ArchConfig, generator, dtype):
    return {
        "ln1": layers.rmsnorm_init(cfg.d_model, generator, dtype),
        "self_attn": _attn_init(cfg, generator, dtype),
        "ln_x": layers.rmsnorm_init(cfg.d_model, generator, dtype),
        "cross_attn": _attn_init(cfg, generator, dtype),
        "ln2": layers.rmsnorm_init(cfg.d_model, generator, dtype),
        "mlp": _gelu_mlp_init(cfg.d_model, cfg.d_ff, generator, dtype),
    }


def _self_qkv(p, cfg, hn, cos, sin):
    q, k, v = layers.qkv_project(p, hn, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.head_dim)
    return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v


def _enc_block(p, cfg, h, cos, sin):
    hn = layers.rmsnorm(p["ln1"], h, cfg.norm_eps)
    q, k, v = _self_qkv(p["attn"], cfg, hn, cos, sin)
    a = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    h = h + layers.out_project(p["attn"], a)
    return h + _gelu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], h, cfg.norm_eps))


def _cross_kv(p, cfg, enc_out):
    """The cross-attention keys and values of the encoder states."""
    dt = enc_out.dtype
    b, se, _ = enc_out.shape
    shape = (b, se, cfg.n_kv_heads, cfg.head_dim)
    return ((enc_out @ p["wk"].to(dt)).reshape(shape),
            (enc_out @ p["wv"].to(dt)).reshape(shape))


def _cross_q(p, cfg, hx):
    """The cross-attention queries of the decoder states (their keys and
    values come from the encoder: `_cross_kv`)."""
    b, s, _ = hx.shape
    return (hx @ p["wq"].to(hx.dtype)).reshape(b, s, cfg.n_heads,
                                               cfg.head_dim)


def _dec_block(p, cfg, h, cos, sin, enc_out):
    """One decoder block over the text. Returns (out, (k, v), (xk, xv))."""
    hn = layers.rmsnorm(p["ln1"], h, cfg.norm_eps)
    q, k, v = _self_qkv(p["self_attn"], cfg, hn, cos, sin)
    a = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
    h = h + layers.out_project(p["self_attn"], a)
    hx = layers.rmsnorm(p["ln_x"], h, cfg.norm_eps)
    qx = _cross_q(p["cross_attn"], cfg, hx)
    xk, xv = _cross_kv(p["cross_attn"], cfg, enc_out)
    ax = flash_attention(qx, xk, xv, causal=False, chunk=cfg.attn_chunk)
    h = h + layers.out_project(p["cross_attn"], ax)
    h = h + _gelu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], h, cfg.norm_eps))
    return h, (k, v), (xk, xv)


class Whisper(nn.Module):
    """Embedding (tied readout), encoder and decoder stacks, their final
    norms. Serving or training parameters as transformer.Transformer."""

    stacked = ("enc_blocks", "dec_blocks")

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype(cfg, trainable)

        def prm(tree):
            return layers.Params(tree, trainable)

        self.embed = prm(layers.embedding_init(cfg.padded_vocab, cfg.d_model,
                                               generator, dt))
        self.enc_blocks = nn.ModuleList(
            prm(enc_block_init(cfg, generator, dt))
            for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(
            prm(dec_block_init(cfg, generator, dt))
            for _ in range(cfg.n_layers))
        self.ln_enc = prm(layers.rmsnorm_init(cfg.d_model, generator, dt))
        self.ln_f = prm(layers.rmsnorm_init(cfg.d_model, generator, dt))

    def _rope(self, n, device, start=0):
        return layers.rope_frequencies(
            self.cfg.head_dim, self.cfg.rope_theta,
            torch.arange(start, start + n, device=device))

    def _stack(self, blocks, x, fn):
        """x through `blocks` by fn(block, x) -> x, each block recomputed
        in the backward pass under cfg.remat."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for p in blocks:
            if remat:
                x = checkpoint(lambda h, p=p: fn(p, h), x,
                               use_reentrant=False)
            else:
                x = fn(p, x)
        return x

    def encode(self, frames):
        """frames (B, Senc, d) from the frontend stub -> encoder states."""
        cfg = self.cfg
        x = frames.to(cfg.compute_dtype)
        cos, sin = self._rope(x.shape[1], x.device)
        x = self._stack(self.enc_blocks, x,
                        lambda p, h: _enc_block(p, cfg, h, cos, sin))
        return layers.rmsnorm(self.ln_enc, x, cfg.norm_eps)

    def _readout(self, x):
        x = layers.rmsnorm(self.ln_f, x, self.cfg.norm_eps)
        return layers.unembed(self.embed, x)

    def forward(self, tokens, frames):
        """frames (B, Senc, d) + text tokens (B, S) -> logits (B, S,
        padded vocab) float32."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        cos, sin = self._rope(x.shape[1], x.device)
        x = self._stack(self.dec_blocks, x, lambda p, h: _dec_block(
            p, cfg, h, cos, sin, enc_out)[0])
        return self._readout(x)

    @torch.no_grad()
    def prefill(self, tokens, frames, max_len: int | None = None):
        """Encode, then run the decoder prompt. Returns (last-position
        logits (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        enc_out = self.encode(frames)
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        b, s, _ = x.shape
        max_len = max(max_len or s, s)
        cache = init_cache(cfg, b, max_len, enc_out.shape[1], x.device)
        cos, sin = self._rope(s, x.device)
        for i, p in enumerate(self.dec_blocks):
            x, (k, v), (xk, xv) = _dec_block(p, cfg, x, cos, sin, enc_out)
            cache["k"][i, :, :s], cache["v"][i, :, :s] = k, v
            cache["xk"][i], cache["xv"][i] = xk, xv
        return self._readout(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One step; pos = the new token's position. Returns (logits (B, 1,
        vocab) float32, cache)."""
        cfg = self.cfg
        pos = int(pos)
        max_len = cache["k"].shape[2]
        if not 0 <= pos < max_len:
            raise IndexError(f"decode position {pos} outside the cache of "
                             f"{max_len} positions")
        x = layers.embed(self.embed, token, cfg.compute_dtype)
        cos, sin = self._rope(1, x.device, start=pos)
        for i, p in enumerate(self.dec_blocks):
            ck, cv = cache["k"][i], cache["v"][i]
            hn = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
            q, k, v = _self_qkv(p["self_attn"], cfg, hn, cos, sin)
            ck[:, pos], cv[:, pos] = k[:, 0], v[:, 0]
            a = decode_attention(q, ck, cv, cache_len=pos + 1)
            x = x + layers.out_project(p["self_attn"], a)
            hx = layers.rmsnorm(p["ln_x"], x, cfg.norm_eps)
            qx = _cross_q(p["cross_attn"], cfg, hx)
            xk = cache["xk"][i]
            ax = decode_attention(qx, xk, cache["xv"][i],
                                  cache_len=xk.shape[1])
            x = x + layers.out_project(p["cross_attn"], ax)
            x = x + _gelu_mlp(p["mlp"], layers.rmsnorm(p["ln2"], x,
                                                       cfg.norm_eps))
        return self._readout(x), cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device):
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.compute_dtype
    return {"k": torch.zeros(kv, dtype=dt, device=device),
            "v": torch.zeros(kv, dtype=dt, device=device),
            "xk": torch.zeros(xkv, dtype=dt, device=device),
            "xv": torch.zeros(xkv, dtype=dt, device=device)}
