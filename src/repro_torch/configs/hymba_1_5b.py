"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
ssm_state=16 — parallel attention + mamba heads per block, 128 meta tokens,
sliding window 1024 except 3 global full-attention layers.
[arXiv:2411.13676; hf]. SWA + O(1) SSM state -> runs long_500k."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=1024,
    global_layers=(0, 15, 31),
    meta_tokens=128,
    chunk=256,
    param_sharding="tp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="qfull",
    ssm_pad_heads=32,
)
