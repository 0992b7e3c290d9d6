"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8) ff=8192 vocab=128256,
SwiGLU, head_dim=128.  [hf:meta-llama/Llama-3.2-3B; unverified]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    head_dim=128,
    d_ff=8192,
    vocab=pad_vocab(128256),  # 128256 (aligned)
    act="swiglu",
    rope_theta=500_000.0,
)
