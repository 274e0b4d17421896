"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks. [arXiv:2405.04517; unverified]. mLSTM (matrix memory) at 10 layers,
sLSTM at layers {5, 11} (the paper's ~7:1 mix); O(1) recurrent state makes
this a long_500k arch."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_state=16,
    chunk=256,
    param_sharding="tp",
)
