"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared (fused 4x1408=5632 wide).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. Routed dispatch = exoshuffle sort path
(DESIGN.md §4.2) — this arch is a primary carrier of the paper's technique.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab=151936,
    n_experts=60,
    top_k=4,
    d_ff_expert=1408,
    shared_d_ff=5632,
    dispatch_impl="sort",
    moe_capacity_factor=1.25,
    rope_theta=10_000.0,
    train_microbatches=4,
    param_sharding="fsdp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="heads",
)
