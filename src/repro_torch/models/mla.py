"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

Twin of src/repro/models/mla.py. Queries and KV are low-rank compressed;
the KV cache stores only the compressed latent c_kv (kv_lora_rank) plus
a shared RoPE key (qk_rope_dim) per position.

Train/prefill uses the *expanded* form (decompress K/V per head and run
flash attention, MHA; the value width v_head_dim differs from the q/k
width). Decode uses the *absorbed* form: W_uk is folded into the query
and W_uv into the output, so attention runs directly against the
compressed cache and the latent never expands at decode time.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.attention import NEG_INF, flash_attention
from repro_torch.models.config import ArchConfig


def mla_init(cfg: ArchConfig, generator: torch.Generator | None, dtype):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    def u(shape):
        return layers.uniform_init(shape, generator, dtype=dtype)

    return {
        "w_dq": u((d, cfg.q_lora_rank)),
        "q_norm": layers.rmsnorm_init(cfg.q_lora_rank, generator, dtype),
        "w_uq": u((cfg.q_lora_rank, h * (dn + dr))),
        "w_dkv": u((d, r + dr)),
        "kv_norm": layers.rmsnorm_init(r, generator, dtype),
        "w_uk": u((r, h * dn)),
        "w_uv": u((r, h * dv)),
        "wo": u((h * dv, d)),
    }


def _latents(p, cfg: ArchConfig, x, positions):
    """Shared q/kv compression. x (B,S,d) -> (q (B,S,H,dn+dr), c_kv, k_rope)."""
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim

    cq = layers.rmsnorm(p["q_norm"], x @ p["w_dq"].to(dt))
    q = (cq @ p["w_uq"].to(dt)).reshape(b, s, h, dn + dr)

    ckv_full = x @ p["w_dkv"].to(dt)
    c_kv = layers.rmsnorm(p["kv_norm"], ckv_full[..., :cfg.kv_lora_rank])
    k_rope = ckv_full[..., cfg.kv_lora_rank:]  # (B, S, dr), shared by heads

    cos, sin = layers.rope_frequencies(dr, cfg.rope_theta, positions)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = layers.apply_rope(q_rope, cos, sin)
    k_rope = layers.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return torch.cat([q_nope, q_rope], dim=-1), c_kv, k_rope


def mla_attention(p, cfg: ArchConfig, x, positions, *, q_chunk=None,
                  causal_skip: bool = False):
    """Expanded-form MLA for train/prefill. Returns (out, (c_kv, k_rope))."""
    dt = x.dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    q, c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"].to(dt)).reshape(b, s, h, dn)
    v = (c_kv @ p["w_uv"].to(dt)).reshape(b, s, h, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    out = flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                          q_chunk=q_chunk, causal_skip=causal_skip)
    out = out.reshape(b, s, h * dv) @ p["wo"].to(dt)
    return out, (c_kv, k_rope)


def mla_decode(p, cfg: ArchConfig, x, cache_c, cache_kr, pos: int):
    """Absorbed-form single-step decode against the compressed cache.

    x (B,1,d); cache_c (B,L,kv_lora); cache_kr (B,L,dr); pos: the new
    token's index (the cache holds `pos` valid entries). The new latent
    is written at `pos` in place. Returns out (B,1,d).
    """
    dt = x.dtype
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    q, c_kv, k_rope = _latents(p, cfg, x, torch.tensor([pos],
                                                      device=x.device))
    cache_c[:, pos] = c_kv[:, 0]
    cache_kr[:, pos] = k_rope[:, 0]

    q_nope = q[..., :dn].reshape(b, h, dn)
    q_rope = q[..., dn:].reshape(b, h, dr)
    # absorb W_uk: q_eff (B,H,r) scores directly against the latent cache
    w_uk = p["w_uk"].to(dt).reshape(r, h, dn)
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)
    s = torch.einsum("bhr,blr->bhl", q_eff, cache_c)
    s = s + torch.einsum("bhr,blr->bhl", q_rope, cache_kr)
    s = s.float() * (dn + dr) ** -0.5
    idx = torch.arange(cache_c.shape[1], device=x.device)
    s = torch.where(idx[None, None] <= pos, s, NEG_INF)
    weights = torch.softmax(s, dim=-1).to(dt)
    ctx = torch.einsum("bhl,blr->bhr", weights, cache_c)  # attended latent
    # absorb W_uv on the way out
    w_uv = p["w_uv"].to(dt).reshape(r, h, dv)
    attn = torch.einsum("bhr,rhv->bhv", ctx, w_uv).reshape(b, 1, h * dv)
    return attn @ p["wo"].to(dt)
