"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf scaled;
unverified]. The vision tower + anyres tile packing is a frontend STUB:
input_specs supplies 576 pre-projected patch embeddings (one base tile);
the backbone is the dense 34B decoder.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    vlm_prefix=576,
    rope_theta=1e6,
    train_microbatches=8,
    param_sharding="fsdp",
    # §Perf-proven sharding (EXPERIMENTS.md): baseline="seq"
    attn_sharding="qfull",
)
