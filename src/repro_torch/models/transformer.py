"""Decoder-only transformer: the dense (GQA) and MoE families.

Twin of src/repro/models/transformer.py for tinyllama-1.1b, granite-3-8b,
mistral-nemo-12b (dense) and qwen2-moe-a2.7b, moonshot-v1-16b-a3b (MoE).
The reference scans one traced block over stacked (L, ...) parameters;
here the model holds an `nn.ModuleList` of `Block`s, one per layer, with
parameters in the config's dtype and no gradients (serving only).

Entry points (methods of `Transformer`):
  forward(tokens)                  -> logits (B, S, vocab) float32
  prefill(tokens, max_len)         -> (last-position logits, cache)
  decode_step(cache, token, pos)   -> (logits (B, 1, vocab), cache)
and `init_params(cfg, generator)`; `init_cache` makes prefill's cache.

The cache is {"k", "v"}: (L, B, max_len, KV, dh) in the compute dtype.
`decode_step` writes position `pos` in place; a position outside the
cache raises (the reference's dynamic_update_slice would clamp it onto
the last entry).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import MoeFFN

#: Where the families this module does not run are queued.
NOT_PORTED = "ROADMAP.md §1 item 14 (the vlm, mla, hybrid, ssm and encdec families)"


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet — "
            f"{NOT_PORTED}")


class Block(nn.Module):
    """One pre-norm block: GQA attention, then a SwiGLU or MoE FFN."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.ln_attn = _params(layers.rmsnorm_init(cfg.d_model, generator, dt))
        self.ln_ffn = _params(layers.rmsnorm_init(cfg.d_model, generator, dt))
        self.attn = _params(layers.gqa_proj_init(
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            generator, dt))
        if cfg.is_moe:
            self.ffn = MoeFFN(cfg, generator)
        elif cfg.d_ff:
            self.ffn = _params(layers.swiglu_init(cfg.d_model, cfg.d_ff,
                                                  generator, dt))
        else:
            self.ffn = None

    def qkv(self, x, cos, sin):
        cfg = self.cfg
        hn = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
        q, k, v = layers.qkv_project(self.attn, hn, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim)
        return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v

    def mlp(self, h):
        z = layers.rmsnorm(self.ln_ffn, h, self.cfg.norm_eps)
        if self.ffn is None:
            return h
        if isinstance(self.ffn, MoeFFN):
            return h + self.ffn(z)
        return h + layers.swiglu(self.ffn, z)

    def forward(self, x, cos, sin):
        """x (B, S, d) -> (out, k, v): the prompt's keys and values too."""
        cfg = self.cfg
        q, k, v = self.qkv(x, cos, sin)
        out = flash_attention(q, k, v, causal=True, window=cfg.window,
                              chunk=cfg.attn_chunk)
        h = x + layers.out_project(self.attn, out)
        return self.mlp(h), k, v

    def decode(self, x, cos, sin, cache_k, cache_v, pos: int):
        """x (B, 1, d); writes this step's k/v at `pos` of the layer's
        cache (B, max_len, KV, dh) in place."""
        q, k, v = self.qkv(x, cos, sin)
        cache_k[:, pos] = k[:, 0]
        cache_v[:, pos] = v[:, 0]
        out = decode_attention(q, cache_k, cache_v, cache_len=pos + 1,
                               window=self.cfg.window)
        return self.mlp(x + layers.out_project(self.attn, out))


class Transformer(nn.Module):
    """Embedding (tied readout), the blocks and the final norm."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.embed = _params(layers.embedding_init(
            cfg.padded_vocab, cfg.d_model, generator, dt))
        self.blocks = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _params(layers.rmsnorm_init(cfg.d_model, generator, dt))

    def _rope(self, positions):
        return layers.rope_frequencies(self.cfg.head_dim, self.cfg.rope_theta,
                                       positions)

    @torch.no_grad()
    def forward(self, tokens):
        """tokens (B, S) int -> logits (B, S, padded vocab) float32."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        cos, sin = self._rope(torch.arange(x.shape[1], device=x.device))
        for blk in self.blocks:
            x, _, _ = blk(x, cos, sin)
        x = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return layers.unembed(self.embed, x)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int | None = None):
        """Run the prompt, building the cache. Returns (logits of the last
        position (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        x = layers.embed(self.embed, tokens, cfg.compute_dtype)
        b, s, _ = x.shape
        max_len = max(max_len or s, s)  # the cache holds at least the prompt
        cache = init_cache(cfg, b, max_len, x.device)
        cos, sin = self._rope(torch.arange(s, device=x.device))
        for i, blk in enumerate(self.blocks):
            x, k, v = blk(x, cos, sin)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = layers.rmsnorm(self.ln_f, x[:, -1:], cfg.norm_eps)
        return layers.unembed(self.embed, x), cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int):
        """One autoregressive step. token (B, 1) int; pos = the number of
        valid cache entries (the new token's position). Returns (logits
        (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        pos = int(pos)
        max_len = cache["k"].shape[2]
        if not 0 <= pos < max_len:
            raise IndexError(f"decode position {pos} outside the cache of "
                             f"{max_len} positions")
        x = layers.embed(self.embed, token, cfg.compute_dtype)
        cos, sin = self._rope(torch.tensor([pos], device=x.device))
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cos, sin, cache["k"][i], cache["v"][i], pos)
        x = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return layers.unembed(self.embed, x), cache


def expected_param_count(cfg: ArchConfig) -> int:
    """The model's parameter count from the config's own arithmetic.
    `params_dense()` counts the vocab and the routed experts unpadded and
    leaves out the norms; the model also holds the padded vocab rows, the
    pad experts (their weights and router columns) and 2L+1 norm scales."""
    d, n = cfg.d_model, cfg.n_layers
    pad_vocab = (cfg.padded_vocab - cfg.vocab) * d
    pad_experts = n * (cfg.n_experts_padded - cfg.n_experts) * (
        3 * d * cfg.d_ff_expert + d)
    return cfg.params_dense() + pad_vocab + pad_experts + (2 * n + 1) * d


def init_params(cfg: ArchConfig, generator: torch.Generator) -> Transformer:
    """A model with weights drawn from `generator`, on its device."""
    return Transformer(cfg, generator)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device):
    """Zero GQA cache: full K/V per layer."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for name in ("k", "v")}


def reference_state(cfg: ArchConfig, tree: dict) -> dict:
    """The reference's parameter pytree (nested dicts of arrays, every
    block leaf stacked (L, ...)) as this model's state dict names:
    blocks.<key> with leading axis L becomes blocks.<i>.<key>."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        else:
            flat[prefix[:-1]] = node

    walk("", tree)
    state = {}
    for name, arr in flat.items():
        if name.startswith("blocks."):
            if arr.shape[0] != cfg.n_layers:
                raise ValueError(f"{name}: leading axis {arr.shape[0]}, "
                                 f"expected {cfg.n_layers} layers")
            rest = name[len("blocks."):]
            for i in range(cfg.n_layers):
                state[f"blocks.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    return state
