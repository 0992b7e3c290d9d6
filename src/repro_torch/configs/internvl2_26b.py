"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) ff=16384 vocab=92553.
InternViT frontend is a STUB: input_specs() provides 1024 precomputed patch
embeddings at d_model.  [arXiv:2404.16821; hf]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    head_dim=128,
    d_ff=16384,
    vocab=pad_vocab(92553),   # 92553 -> 92672
    act="swiglu",
    n_patches=1024,
    seq_parallel=True,  # 6144-wide residuals: SP shards norm/residual
                        # activations 16x (EXPERIMENTS §Perf cell E)
)
