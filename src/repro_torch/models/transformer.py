"""Decoder-only transformer: the dense (GQA), MLA, MoE and VLM families.

Twin of src/repro/models/transformer.py for tinyllama-1.1b, granite-3-8b,
mistral-nemo-12b (dense), minicpm3-4b (MLA, models/mla.py),
qwen2-moe-a2.7b, moonshot-v1-16b-a3b (MoE) and llava-next-34b (the dense
backbone behind a patch-embedding stub: `prefix_embeds` (B, P, d) go
before the text). The reference scans one traced block over stacked
(L, ...) parameters; here the model holds an `nn.ModuleList` of
`Block`s, one per layer.

Two kinds of model, as `trainable` says:
  - serving (the default): parameters stored in the config's dtype,
    without gradients;
  - training: float32 master parameters with gradients, each weight cast
    to the config's compute dtype where the reference casts it, and with
    `cfg.remat` each block recomputed in the backward pass
    (torch.utils.checkpoint, the twin of the reference's jax.checkpoint).

Entry points (methods of `Transformer`):
  forward(tokens, prefix_embeds=None)  -> logits (B, P + S, vocab)
                                          float32, under autograd
                                          (training)
  prefill(tokens, max_len, prefix_embeds=None)
                                       -> (last-position logits, cache)
  decode_step(cache, token, pos)       -> (logits (B, 1, vocab), cache)
and `Transformer(cfg, generator)` draws the weights on the generator's
device; `init_cache` makes prefill's cache.
Each takes the mesh as a batch axis (`ep_size`, `dp`; see models/moe.py),
or the model is built on a rank (`Transformer(..., mesh=)`, a
launch/mesh.RankMesh): it then holds the rank's slice of each tensor
that launch/sharding.split_dims names (`placement`), and the entry
points take the rank's data row of the batch. For the
`attn_sharding="heads"` configs of the dense and MoE families that is
Megatron's tensor parallelism over "model" (tp ranks): a rank holds
H/tp contiguous query heads and the KV/tp KV heads they use, 1/tp of
the FFN's (or the shared experts') width and the vocab rows
[i * V/tp, (i + 1) * V/tp) of the tied table; each block's attention
and FFN outputs are partial sums, summed over "model"; its KV cache
holds the rank's KV heads; its logits are the rank's vocab slice
(launch/sharding.logits_pspec). `forward` (training) keeps the
residual stream between blocks split over the sequence when S % tp ==
0 (Megatron-SP, the reference's constrain_acts), so the norms see a
rank's tokens only and their scales' gradients are partial
(`sp_partial`); `prefill` and `decode_step` keep it replicated, as the
reference does. A `heads` config whose KV heads do not divide tp
raises NotImplementedError (ROADMAP.md §1 item 2). MoE blocks also
hold E/tp experts and dispatch over the ranks; every other config is
replicated on a rank, apart from its expert banks.
Where the reference lays attention out for `attn_sharding="qfull"`, the
query is one chunk here too (`q_chunk=0`); `cfg.causal_skip` visits only
the live chunk pairs.

The cache is {"k", "v"}: (L, B, max_len, KV, dh) in the compute dtype;
MLA caches the latent instead, {"c": (L, B, max_len, kv_lora_rank),
"kr": (L, B, max_len, qk_rope_dim)}. `decode_step` writes position `pos`
in place; a position outside the cache raises (the reference's
dynamic_update_slice would clamp it onto the last entry).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.collectives import gather_rows, split_rows
from repro_torch.launch.sharding import (is_tensor_parallel, split_dims,
                                         split_of)
from repro_torch.models import layers, mla
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import MoeFFN

#: The families this module builds.
FAMILIES = ("dense", "mla", "moe", "vlm")


def param_dtype(cfg: ArchConfig, trainable: bool) -> torch.dtype:
    """Storage type of the parameters: float32 masters for training, the
    config's dtype for serving."""
    return torch.float32 if trainable else cfg.compute_dtype


def _params(tensors: dict, requires_grad: bool) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=requires_grad)
                             for k, v in tensors.items()})


def q_chunk_of(cfg: ArchConfig):
    """The query chunking the reference uses: one chunk under
    attn_sharding="qfull", else the key chunk."""
    return 0 if cfg.attn_sharding == "qfull" else None


def cache_names(cfg: ArchConfig) -> tuple[str, str]:
    return ("c", "kr") if cfg.family == "mla" else ("k", "v")


def tensor_parallel(cfg: ArchConfig, mesh) -> int:
    """tp of a model of `cfg` on a rank of `mesh`: the "model" axis's size
    for the dense and MoE families' `attn_sharding="heads"` configs, else
    1 (replicated). Raises NotImplementedError where the rules' split is
    not executed: KV heads that do not divide tp (the reference then
    splits wk's head_dim and shards the cache's sequence over "model"),
    or an FFN, shared-expert or vocab width that does not."""
    if mesh is None or not is_tensor_parallel(cfg) \
            or "model" not in mesh.axes:
        return 1
    tp = mesh.size_of("model")
    kv = (1, 1, cfg.n_kv_heads, cfg.head_dim)  # (B, S, KV, dh)
    if tp > 1 and layers.constrain_heads(kv, mesh)[2] != "model":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.n_kv_heads} KV heads do not split over "
            f"{tp} ranks of 'model' (the reference then splits wk's "
            "head_dim and the cache's sequence over 'model'; ROADMAP.md "
            "§1 item 2)")
    for what, n in (("d_ff", cfg.d_ff), ("shared_d_ff", cfg.shared_d_ff),
                    ("padded vocab", cfg.padded_vocab)):
        if n % tp:
            raise NotImplementedError(
                f"{cfg.name}: {what} {n} does not split over {tp} ranks of "
                "'model' (ROADMAP.md §1 item 2)")
    return tp


class Block(nn.Module):
    """One pre-norm block: GQA or MLA attention, then a SwiGLU or MoE
    FFN."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 trainable: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        dt = param_dtype(cfg, trainable)
        tp = tensor_parallel(cfg, mesh)
        #: the rank's mesh for the tensor-parallel layers, or None
        self.tp = mesh if tp > 1 else None
        self.heads, self.kv_heads = cfg.n_heads // tp, cfg.n_kv_heads // tp
        split = split_of(cfg, mesh, "blocks.0.")

        def prm(tensors, prefix):
            # each tensor drawn whole, in the one-process order, then cut
            return _params(layers.placed(tensors, split, prefix, mesh),
                           trainable)

        self.ln_attn = prm(layers.rmsnorm_init(cfg.d_model, generator, dt),
                           "ln_attn.")
        self.ln_ffn = prm(layers.rmsnorm_init(cfg.d_model, generator, dt),
                          "ln_ffn.")
        if cfg.family == "mla":
            self.attn = layers.Params(mla.mla_init(cfg, generator, dt),
                                      trainable)
        else:
            self.attn = prm(layers.gqa_proj_init(
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                generator, dt), "attn.")
        if cfg.is_moe:
            self.ffn = MoeFFN(cfg, generator, dtype=dt,
                              requires_grad=trainable, mesh=mesh)
        elif cfg.d_ff:
            self.ffn = prm(layers.swiglu_init(cfg.d_model, cfg.d_ff,
                                              generator, dt), "ffn.")
        else:
            self.ffn = None

    def qkv(self, x, cos, sin, sp: bool = False):
        cfg = self.cfg
        hn = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
        q, k, v = layers.qkv_project(self.attn, hn, self.heads,
                                     self.kv_heads, cfg.head_dim,
                                     mesh=self.tp, sp=sp)
        return layers.apply_rope(q, cos, sin), layers.apply_rope(k, cos, sin), v

    def mlp(self, h, ep_size: int, dp: int, sp: bool = False):
        z = layers.rmsnorm(self.ln_ffn, h, self.cfg.norm_eps)
        if self.ffn is None:
            return h
        if not isinstance(self.ffn, MoeFFN):
            return h + layers.swiglu(self.ffn, z, mesh=self.tp, sp=sp)
        if not sp:
            return h + self.ffn(z, ep_size=ep_size, dp=dp)
        # the routed path runs replicated over "model": gather the
        # sequence into it (backward: this rank's slice, unsummed) and
        # keep this rank's slice of its output
        z = gather_rows(z.transpose(0, 1), self.tp, "model",
                        what="moe.seq").transpose(0, 1)
        f = self.ffn(z, ep_size=ep_size, dp=dp)
        return h + split_rows(f.transpose(0, 1), self.tp, "model",
                              what="moe.seq").transpose(0, 1)

    def forward(self, x, cos, sin, positions, ep_size: int = 1, dp: int = 1,
                sp: bool = False):
        """x (B, S, d) -> (out, a, b): the prompt's cache entries too (k and
        v, or MLA's latent c_kv and k_rope). Under `sp` (a TP rank), x is
        the rank's sequence slice (B, S/tp, d) and so is the output;
        cos, sin and positions cover the whole sequence."""
        cfg = self.cfg
        if cfg.family == "mla":
            hn = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
            out, (a, b) = mla.mla_attention(
                self.attn, cfg, hn, positions, q_chunk=q_chunk_of(cfg),
                causal_skip=cfg.causal_skip)
            return self.mlp(x + out, ep_size, dp), a, b
        q, k, v = self.qkv(x, cos, sin, sp)
        out = flash_attention(q, k, v, causal=True, window=cfg.window,
                              chunk=cfg.attn_chunk, q_chunk=q_chunk_of(cfg),
                              causal_skip=cfg.causal_skip)
        h = x + layers.out_project(self.attn, out, mesh=self.tp, sp=sp)
        return self.mlp(h, ep_size, dp, sp), k, v

    def decode(self, x, cos, sin, cache_a, cache_b, pos: int,
               ep_size: int = 1, dp: int = 1):
        """x (B, 1, d); writes this step's entries at `pos` of the layer's
        cache in place: k/v (B, max_len, KV, dh), or MLA's latent."""
        cfg = self.cfg
        if cfg.family == "mla":
            hn = layers.rmsnorm(self.ln_attn, x, cfg.norm_eps)
            out = mla.mla_decode(self.attn, cfg, hn, cache_a, cache_b, pos)
            return self.mlp(x + out, ep_size, dp)
        q, k, v = self.qkv(x, cos, sin)
        cache_a[:, pos] = k[:, 0]
        cache_b[:, pos] = v[:, 0]
        out = decode_attention(q, cache_a, cache_b, cache_len=pos + 1,
                               window=cfg.window)
        return self.mlp(x + layers.out_project(self.attn, out, mesh=self.tp),
                        ep_size, dp)


class Transformer(nn.Module):
    """Embedding (tied readout), the blocks and the final norm."""

    stacked = ("blocks",)  # the reference stacks the layers' leaves

    def __init__(self, cfg: ArchConfig, generator: torch.Generator | None,
                 *, trainable: bool = False, mesh=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a "
                             f"transformer family {FAMILIES}")
        self.cfg = cfg
        self.trainable = trainable
        self.mesh = mesh
        #: {state name: dim} of the tensors this rank holds its slice of
        #: (launch/sharding.rank_split reads it)
        self.placement = split_dims(cfg, mesh) if mesh is not None else {}
        self.tp = mesh if tensor_parallel(cfg, mesh) > 1 else None
        dt = param_dtype(cfg, trainable)
        self.embed = _params(layers.placed(layers.embedding_init(
            cfg.padded_vocab, cfg.d_model, generator, dt), self.placement,
            "embed.", mesh), trainable)
        self.blocks = nn.ModuleList(Block(cfg, generator, trainable, mesh)
                                    for _ in range(cfg.n_layers))
        self.ln_f = _params(layers.rmsnorm_init(cfg.d_model, generator, dt),
                            trainable)

    def seq_parallel(self, seq: int) -> bool:
        """Whether `forward` over `seq` positions keeps the residual
        stream split over the sequence: on a TP rank, when the sequence
        divides over "model" (layers.constrain_acts)."""
        return self.tp is not None and layers.constrain_acts(
            (1, seq, self.cfg.d_model), self.tp)[1] == "model"

    def sp_partial(self, seq: int) -> list[str]:
        """The replicated parameters whose gradients a TP rank's `forward`
        over `seq` positions leaves partial (its tokens' share): the norm
        scales under sequence parallelism, none otherwise."""
        if not self.seq_parallel(seq):
            return []
        return [n for n, _ in self.named_parameters()
                if n.endswith(".scale")]

    def _rope(self, positions):
        return layers.rope_frequencies(self.cfg.head_dim, self.cfg.rope_theta,
                                       positions)

    def _inputs(self, tokens, prefix_embeds, sp: bool = False):
        """The embedded text after any VLM prefix (the rank's sequence
        slice under sp), with the positions of the whole sequence and
        their rotary factors."""
        dt = self.cfg.compute_dtype
        x = layers.embed(self.embed, tokens, dt, mesh=self.tp, sp=sp)
        if prefix_embeds is not None:
            x = torch.cat([prefix_embeds.to(dt), x], dim=1)
        s = tokens.shape[1] + (0 if prefix_embeds is None
                               else prefix_embeds.shape[1])
        positions = torch.arange(s, device=x.device)
        return x, positions, *self._rope(positions)

    def forward(self, tokens, prefix_embeds=None, *, ep_size: int = 1,
                dp: int = 1):
        """tokens (B, S) int; prefix_embeds (B, P, d) for the VLM stub ->
        logits (B, P + S, padded vocab) float32, under autograd when the
        parameters take gradients."""
        cfg = self.cfg
        sp = self.seq_parallel(tokens.shape[1])
        x, positions, cos, sin = self._inputs(tokens, prefix_embeds, sp)
        remat = cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(lambda h, blk=blk: blk(
                    h, cos, sin, positions, ep_size, dp, sp)[0],
                    x, use_reentrant=False)
            else:
                x = blk(x, cos, sin, positions, ep_size, dp, sp)[0]
        x = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return layers.unembed(self.embed, x, mesh=self.tp, sp=sp)

    @torch.no_grad()
    def prefill(self, tokens, max_len: int | None = None, prefix_embeds=None,
                *, ep_size: int = 1, dp: int = 1):
        """Run the prompt (after any VLM prefix), building the cache.
        Returns (logits of the last position (B, 1, vocab) float32,
        cache)."""
        cfg = self.cfg
        x, positions, cos, sin = self._inputs(tokens, prefix_embeds)
        b, s, _ = x.shape
        # s counts any VLM prefix; the cache holds at least the prompt
        max_len = max(max_len or s, s)
        cache = init_cache(cfg, b, max_len, x.device, mesh=self.mesh)
        na, nb = cache_names(cfg)
        for i, blk in enumerate(self.blocks):
            x, a, bb = blk(x, cos, sin, positions, ep_size, dp)
            cache[na][i, :, :s] = a
            cache[nb][i, :, :s] = bb
        x = layers.rmsnorm(self.ln_f, x[:, -1:], cfg.norm_eps)
        return layers.unembed(self.embed, x, mesh=self.tp), cache

    @torch.no_grad()
    def decode_step(self, cache, token, pos: int, *, ep_size: int = 1,
                    dp: int = 1):
        """One autoregressive step. token (B, 1) int; pos = the number of
        valid cache entries (the new token's position). Returns (logits
        (B, 1, vocab) float32, cache)."""
        cfg = self.cfg
        pos = int(pos)
        na, nb = cache_names(cfg)
        max_len = cache[na].shape[2]
        if not 0 <= pos < max_len:
            raise IndexError(f"decode position {pos} outside the cache of "
                             f"{max_len} positions")
        x = layers.embed(self.embed, token, cfg.compute_dtype, mesh=self.tp)
        cos, sin = self._rope(torch.tensor([pos], device=x.device))
        for i, blk in enumerate(self.blocks):
            x = blk.decode(x, cos, sin, cache[na][i], cache[nb][i], pos,
                           ep_size, dp)
        x = layers.rmsnorm(self.ln_f, x, cfg.norm_eps)
        return layers.unembed(self.embed, x, mesh=self.tp), cache


def expected_param_count(cfg: ArchConfig) -> int:
    """The model's parameter count from the config's own arithmetic.
    `params_dense()` counts the vocab and the routed experts unpadded and
    leaves out the norms; the model also holds the padded vocab rows, the
    pad experts (their weights and router columns), 2L+1 norm scales and,
    with MLA, the q and kv latent norms of each layer."""
    d, n = cfg.d_model, cfg.n_layers
    pad_vocab = (cfg.padded_vocab - cfg.vocab) * d
    pad_experts = n * (cfg.n_experts_padded - cfg.n_experts) * (
        3 * d * cfg.d_ff_expert + d)
    latent_norms = n * (cfg.q_lora_rank + cfg.kv_lora_rank) \
        if cfg.family == "mla" else 0
    return (cfg.params_dense() + pad_vocab + pad_experts
            + (2 * n + 1) * d + latent_norms)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device,
               mesh=None):
    """Zero cache: full K/V per layer, or MLA's latent and rope key. On a
    TP rank of `mesh`, K/V hold the rank's KV/tp heads
    (launch/sharding.cache_pspecs: KV heads over "model"; `batch` is the
    rank's data row)."""
    lead = (cfg.n_layers, batch, max_len)
    if cfg.family == "mla":
        shapes = {"c": lead + (cfg.kv_lora_rank,),
                  "kr": lead + (cfg.qk_rope_dim,)}
    else:
        kv = cfg.n_kv_heads // tensor_parallel(cfg, mesh)
        shapes = {name: lead + (kv, cfg.head_dim) for name in ("k", "v")}
    return {name: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
            for name, shape in shapes.items()}
