"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865 — enc-dec, conv frontend stubbed. [arXiv:2212.04356;
unverified]. input_specs supplies post-conv frame embeddings
(enc_len = seq//4); full attention both sides, so long_500k is skipped."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab=51865,
    param_sharding="tp",
)
