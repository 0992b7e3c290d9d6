"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) ff=6912 vocab=262144,
5:1 local:global sliding window, head_dim=256, GeGLU.
[hf:google/gemma-3-1b-pt; unverified]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv=1,
    head_dim=256,
    d_ff=6912,
    vocab=pad_vocab(262144),  # 262144 (already aligned)
    act="geglu",
    rope_theta=1_000_000.0,
    window=512,
    global_every=6,           # layers 6,12,18,24 are global (5 local : 1 global)
)
