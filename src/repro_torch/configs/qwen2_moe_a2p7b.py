"""qwen2-moe-a2.7b [moe]: 24L d=2048 16H (kv=16) vocab=151936,
60 routed experts top-4 (expert ff=1408) + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    head_dim=128,
    d_ff=1408,
    vocab=pad_vocab(151936),  # 151936 (aligned to 16; /128 ok: 1187*128)
    act="swiglu",
    n_experts=60,
    top_k=4,
    n_shared=4,
    expert_dff=1408,
)
