"""zamba2-1.2b [hybrid]: 38 Mamba2 layers d=2048 (ssm_state=64) + ONE
weight-shared attention block (32H kv=32 hd=64, ff=8192) applied after every
6 SSM layers (simplified from Zamba2's 2-block rotation; DESIGN.md §7).
vocab=32000.  [arXiv:2411.15242; hf]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    head_dim=64,
    d_ff=8192,
    vocab=pad_vocab(32000),   # 32000 (aligned)
    ssm_state=64,
    ssm_headdim=64,           # d_inner=4096 -> 64 SSD heads
    ssm_chunk=128,
    attn_every=6,             # 6 groups of 6 + 2-layer tail
)
