"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf].
Nemo fixes head_dim=128 (not d_model/n_heads)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
    train_microbatches=4,
    param_sharding="fsdp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="heads",
)
