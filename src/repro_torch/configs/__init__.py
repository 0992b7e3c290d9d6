"""Architecture registry + input-shape cells, as the reference's
(``repro/configs/__init__.py``): the same ten architectures with the same
values, so ``get_config`` and ``shape_cells`` agree between the packages for
every arch.  Each config file is pure data.

Ten assigned architectures (exact published configs; vocab padded up to a
multiple of 128 for model-axis sharding — original sizes kept in comments),
plus the paper's own RNS bases (``paper_rns``).  The port trains the dense
family (``models/model.py``).

Shape cells (per assignment):
    train_4k     seq 4096,   global_batch 256   (train_step)
    prefill_32k  seq 32768,  global_batch 32    (serve prefill)
    decode_32k   seq 32768,  global_batch 128   (serve decode, 1 new token)
    long_500k    seq 524288, global_batch 1     (long-context decode)

``long_500k`` runs only for sub-quadratic archs (ssm/hybrid/sliding-window);
pure full-attention archs skip it (DESIGN.md §6).  Encoder-only archs would
skip decode cells, but none of the ten is encoder-only.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "gemma3_1b",
    "gemma_2b",
    "gemma_7b",
    "llama32_3b",
    "mamba2_370m",
    "whisper_tiny",
    "internvl2_26b",
    "zamba2_1p2b",
    "qwen2_moe_a2p7b",
    "moonshot_v1_16b_a3b",
]

# CLI ids (match the assignment spelling) -> module names
ALIASES = {
    "gemma3-1b": "gemma3_1b",
    "gemma-2b": "gemma_2b",
    "gemma-7b": "gemma_7b",
    "llama3.2-3b": "llama32_3b",
    "mamba2-370m": "mamba2_370m",
    "whisper-tiny": "whisper_tiny",
    "internvl2-26b": "internvl2_26b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def pad_vocab(v: int) -> int:
    """Round up to a multiple of 128 so vocab shards over the model axis."""
    return -(-v // 128) * 128


def get_config(name: str) -> ModelConfig:
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG.validate()


def shape_cells(cfg: ModelConfig) -> list[str]:
    """The shape cells this arch runs (skip rules in DESIGN.md §6)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    sub_quadratic = cfg.family in ("ssm", "hybrid") or bool(cfg.window)
    if sub_quadratic and cfg.family != "encdec":
        cells.append("long_500k")
    return cells
