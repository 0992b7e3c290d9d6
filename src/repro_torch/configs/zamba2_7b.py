"""zamba2-7b [hybrid, the published layout]: 81 Mamba2 layers d=3584
(112 SSD heads of 64, ssm_state=64, 2 B/C groups, chunk 256); before the
Mamba2 layer of each of the 13 hybrid layers, one of 2 shared
attention+MLP blocks in turn (32H kv=32 hd=224 over concat(hidden,
embedding), scale (hd/2)^-0.5; exact-GELU MLP ff=14336 with a rank-128
adapter per hybrid layer) and a 3584 x 3584 linear per hybrid layer.
vocab=32000, tied.  Port only: not in ARCHS (the registry is the
reference's); ``get_config("zamba2_7b")`` reaches it by module name.
[arXiv:2411.15242; hf:Zyphra/Zamba2-7B-Instruct config.json]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    head_dim=224,             # attention_head_dim: 2 d / heads
    d_ff=14336,
    vocab=32000,
    act="geglu_exact",        # hidden_act "gelu" (erf), gated
    norm_eps=1e-5,
    ssm_state=64,
    ssm_headdim=64,           # d_inner=7168 -> 112 SSD heads
    ssm_chunk=256,
    ssm_groups=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_mem_blocks=2,
    adapter_rank=128,
)
