"""minicpm3-4b [dense/MLA]: 62L d_model=2560 40H d_ff=6400 vocab=73448 — MLA.
[hf:openbmb/MiniCPM3-4B; hf]. q_lora=768, kv_lora=256, qk_nope=64,
qk_rope=32, v_head=64. The latent KV cache is ~9x smaller than GQA at
these dims; attention is still full-context (long_500k skipped,
DESIGN.md §5)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="mla",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,  # MLA is MHA over latent
    d_ff=6400,
    vocab=73448,
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    d_head=96,  # qk_nope + qk_rope
    rope_theta=10_000.0,
    train_microbatches=2,
    param_sharding="tp",
    # §Perf-proven sharding (EXPERIMENTS.md): 40 heads % 16 != 0 -> seq-parallel
    attn_sharding="qfull",
)
