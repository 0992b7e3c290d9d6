"""whisper-tiny [audio]: 4L enc + 4L dec, d=384 6H ff=1536 vocab=51865,
head_dim=64.  Conv frontend is a STUB: input_specs() provides precomputed
frame embeddings, padded 1500 -> 1536 frames so chunked attention tiles
evenly (DESIGN.md §7).  [arXiv:2212.04356; unverified]"""
from . import pad_vocab
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv=6,
    head_dim=64,
    d_ff=1536,
    vocab=pad_vocab(51865),   # 51865 -> 51968
    act="geglu",
    enc_layers=4,
    enc_frames=1536,          # 1500 mel frames padded to 3*512
)
