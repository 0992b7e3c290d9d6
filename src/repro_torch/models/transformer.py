"""Decoder-only transformer stack (the dense family): init and the training
forward, as the reference's ``repro/models/transformer.py`` builds them.

Parameters keep the reference's tree, leaf names and shapes: the layers are
stacked on a leading L axis, as ``jax.vmap`` stacks them, so the gradient
codec's wire buffer holds the leaves in the reference's order.  The stack
is a Python loop over the layers; gemma3's 5:1 local:global pattern is a
per-layer window.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` and is recomputed in the backward pass.

Prefill, decode and extend, the windowed ring cache and the MoE block come
with later slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..dist import _tree
from .attention import attn_forward, init_attn
from .config import ModelConfig
from .layers import embed, gated_mlp, init_linear, init_mlp, init_norm, rms_norm, unembed

__all__ = ["NO_WINDOW", "global_flags", "layer_window", "init_dense_block",
           "init_decoder_only", "decoder_stack", "decoder_only_logits"]

NO_WINDOW = 1 << 40  # "infinite" window of a global layer


# --------------------------------------------------------------------- util
def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _pdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def global_flags(cfg: ModelConfig) -> np.ndarray:
    """(L,) bool: True where the layer is global-attention (gemma3 5:1)."""
    if not cfg.window:
        return np.ones(cfg.n_layers, dtype=bool)
    return np.asarray(
        [(i % cfg.global_every) == cfg.global_every - 1 for i in range(cfg.n_layers)]
    )


def layer_window(cfg: ModelConfig, is_global):
    """The layer's window (None when the arch has no windows)."""
    if not cfg.window:
        return None
    return NO_WINDOW if is_global else cfg.window


# --------------------------------------------------------------------- init
def init_dense_block(gen, cfg: ModelConfig, dt, device, lead=()):
    """One dense block's parameters; ``lead`` prefixes each shape (the
    stacked layer axis)."""
    lead = tuple(lead)
    d = cfg.d_model
    return {
        "ln1": init_norm(lead + (d,), dt, device),
        "attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.head_dim, dt,
                          device, lead),
        "ln2": init_norm(lead + (d,), dt, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, dt, device, lead),
    }


def init_decoder_only(gen, cfg: ModelConfig, device):
    dt = _pdtype(cfg)
    return {
        "embed": init_linear(gen, (cfg.vocab, cfg.d_model), dt, device),
        "layers": init_dense_block(gen, cfg, dt, device, lead=(cfg.n_layers,)),
        "final_norm": init_norm((cfg.d_model,), dt, device),
    }


# ----------------------------------------------------------------- forward
def _block(cfg: ModelConfig, pl, x, positions, window):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attn_forward(
        pl["attn"], h, positions, heads=cfg.n_heads, kv=cfg.n_kv,
        hd=cfg.head_dim, theta=cfg.rope_theta, window=window,
    )
    h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + gated_mlp(h2, pl["mlp"]["wi"], pl["mlp"]["wo"], cfg.act)


def decoder_stack(cfg: ModelConfig, params, x, positions):
    """Run the layer stack.  Returns (x, aux_loss); aux is 0 for dense."""
    leaves, spec = _tree.flatten(params["layers"])
    per_layer = [leaf.unbind(0) for leaf in leaves]   # one backward stack
    for i, is_global in enumerate(global_flags(cfg)):
        pl = _tree.unflatten(spec, [t[i] for t in per_layer])
        window = layer_window(cfg, is_global)
        if cfg.remat:
            x = checkpoint(_block, cfg, pl, x, positions, window,
                           use_reentrant=False)
        else:
            x = _block(cfg, pl, x, positions, window)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_only_logits(cfg: ModelConfig, params, batch):
    """Training forward.  batch["tokens"]: (b, s) inputs.  Returns (logits,
    aux); the unembedding is tied to ``embed``."""
    dt = _dtype(cfg)
    x = embed(batch["tokens"], params["embed"], dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux = decoder_stack(cfg, params, x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]), aux
