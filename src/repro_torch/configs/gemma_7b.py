"""gemma-7b [dense]: 28L d=3072 16H (kv=16) ff=24576 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv=16,
    head_dim=256,
    d_ff=24576,
    vocab=pad_vocab(256000),
    act="geglu",
)
