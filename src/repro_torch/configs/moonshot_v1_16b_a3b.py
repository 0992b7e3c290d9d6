"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) vocab=163840,
64 routed experts top-6 (expert ff=1408) + 2 shared (Moonlight config).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,
    vocab=pad_vocab(163840),  # 163840 (aligned)
    act="swiglu",
    n_experts=64,
    top_k=6,
    n_shared=2,
    expert_dff=1408,
)
