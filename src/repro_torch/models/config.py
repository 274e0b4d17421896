"""Architecture configuration — one dataclass covers all 10 assigned archs.

Twin of src/repro/models/config.py: the same dataclass and arithmetic;
only `compute_dtype` is a torch dtype.

Families:
  dense  : decoder-only transformer, GQA attention (granite, mistral-nemo,
           tinyllama; llava's backbone)
  mla    : dense with Multi-head Latent Attention (minicpm3)
  moe    : dense attention + mixture-of-experts FFN (qwen2-moe, moonshot)
  ssm    : xLSTM recurrent blocks, no FFN (xlstm-125m)
  hybrid : parallel attention + SSM heads per block (hymba)
  encdec : encoder-decoder with stubbed conv frontend (whisper)
  vlm    : dense backbone + stubbed patch-embedding frontend (llava-next)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | mla | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    shared_d_ff: int = 0  # combined shared-expert width (0 = none)
    dispatch_impl: str = "sort"  # sort | onehot | dense (single-device)
    moe_capacity_factor: float = 1.25

    # --- MLA (minicpm3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    # pad the SSM head count up to this value (0 = off) so heads shard
    # evenly over the model axis; padded heads have zero input gate and
    # never contribute (see EXPERIMENTS.md §Perf, hymba cell).
    ssm_pad_heads: int = 0
    window: int = 0  # sliding-window size (0 = full attention)
    global_layers: Sequence[int] = ()  # layers with full attention (hybrid)
    chunk: int = 256  # chunkwise-recurrence length (mLSTM / SSD)
    meta_tokens: int = 0  # hymba learnable prefix

    # --- encoder-decoder (whisper) ---
    enc_layers: int = 0

    # --- frontends (stubs) ---
    vlm_prefix: int = 0  # patch-embedding positions reserved at seq front

    # --- numerics / parallelism policy ---
    dtype: str = "bfloat16"
    param_sharding: str = "tp"  # tp | fsdp
    # "seq": activations stay sequence-sharded into attention (baseline —
    #   GSPMD partitions the chunked-attention loop poorly; kept selectable
    #   for the before/after in EXPERIMENTS.md §Perf).
    # "heads": explicit head-parallel constraints on q/k/v around attention
    #   (Megatron-style: model axis shards heads, seq gathered locally).
    attn_sharding: str = "seq"
    # enumerate only lower-triangular (q-chunk, kv-chunk) attention pairs —
    # halves attention flops/tile-traffic vs the rectangular grid.
    causal_skip: bool = False
    remat: bool = True
    attn_chunk: int = 512  # flash-attention KV block
    train_microbatches: int = 1  # gradient-accumulation steps per train step

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 so the embedding/logits shard evenly over
        any TP degree up to 256 (standard practice; pad ids are never
        targeted by the loss)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_experts_padded(self) -> int:
        """Routed expert count rounded up to 16 so the expert stacks shard
        evenly over any EP degree up to 16 (or 64 with 16 | E). Pad experts
        exist as parameters but the router never selects them (qwen2-moe:
        60 -> 64)."""
        if self.n_experts == 0:
            return 0
        return ((self.n_experts + 15) // 16) * 16

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.family == "encdec"

    @property
    def is_moe(self) -> bool:
        return self.family == "moe"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state: SSM or hybrid (windowed + SSM) archs."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper is enc-dec)

    def params_dense(self) -> int:
        """Approximate parameter count (embedding + blocks), for rooflines."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d
        if self.family in ("dense", "vlm", "moe"):
            attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
        elif self.family == "mla":
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        elif self.family == "ssm":
            attn = 4 * d * d  # qkv + gates + out of the mLSTM block
        elif self.family == "hybrid":
            attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv_heads * self.head_dim * 2
            attn += 2 * d * d // 2  # ssm branch in/out
        elif self.family == "encdec":
            attn = 4 * d * d * 2  # self + cross (decoder); enc counted via layers
        else:
            attn = 4 * d * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * self.d_ff_expert + 3 * d * self.shared_d_ff
            ffn += d * self.n_experts  # router
        elif self.d_ff > 0:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 0
        return emb + l * (attn + ffn)

    def params_active(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.params_dense()
        d, l = self.d_model, self.n_layers
        dense = self.params_dense()
        routed_all = l * self.n_experts * 3 * d * self.d_ff_expert
        routed_active = l * self.top_k * 3 * d * self.d_ff_expert
        return dense - routed_all + routed_active

    def reduced(self, **over) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            attn_chunk=32,
            chunk=16,
            param_sharding="tp",
        )
        if self.is_moe:
            # capacity high enough that smoke tests never drop tokens —
            # capacity-dropping depends on how many tokens compete, which
            # legitimately differs between forward (B*S) and decode (B),
            # and would break decode-parity checks.
            small.update(n_experts=8, top_k=2, d_ff_expert=32, shared_d_ff=64,
                         dispatch_impl="dense", moe_capacity_factor=8.0)
        if self.family == "mla":
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16)
        if self.family in ("ssm", "hybrid"):
            small.update(ssm_state=8)
        if self.family == "hybrid":
            small.update(window=32, global_layers=(0,), meta_tokens=8)
        if self.family == "encdec":
            small.update(enc_layers=2)
        if self.family == "vlm":
            small.update(vlm_prefix=16)
        small.update(over)
        return dataclasses.replace(self, **small)
