"""mamba2-370m [ssm]: 48L d=1024 attn-free, vocab=50280, ssm_state=128.
SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv=0,
    head_dim=0,
    d_ff=0,
    vocab=pad_vocab(50280),   # 50280 -> 50304
    ssm_state=128,
    ssm_headdim=64,           # d_inner=2048 -> 32 SSD heads
    ssm_chunk=128,
)
