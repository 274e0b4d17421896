"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small. [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32000,
    rope_theta=10_000.0,
    param_sharding="tp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="heads",
)
