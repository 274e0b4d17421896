"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=163840, MoE 64 routed top-6 + 2 shared (fused 2x1408=2816 wide) —
kimi/moonlight. [hf:moonshotai/Moonlight-16B-A3B; hf]. Exoshuffle sort
dispatch, as qwen2-moe."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab=163840,
    n_experts=64,
    top_k=6,
    d_ff_expert=1408,
    shared_d_ff=2816,
    dispatch_impl="sort",
    moe_capacity_factor=1.25,
    rope_theta=50_000.0,
    train_microbatches=4,
    param_sharding="fsdp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="heads",
)
