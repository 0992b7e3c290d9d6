"""Shared neural-net layers: RMSNorm, RoPE, gated MLPs, embeddings.

Plain functions over tensors and parameter dicts, in the reference's
layouts (``repro/models/layers.py``).  Every dtype is explicit, and each
rounds where the reference rounds: the norm's mean in f32, the rotary
angles in f32 cast to the activations' dtype, the embedding scale computed
in the compute dtype, GeGLU's GELU in its tanh form (``jax.nn.gelu``'s
default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm",
    "rope",
    "gated_mlp",
    "init_linear",
    "init_norm",
    "init_mlp",
    "embed",
    "unembed",
]


def rms_norm(x, scale, eps: float = 1e-6):
    """Mean-square reduction in f32; the normalize and scale multiplies stay
    in the input dtype, ``x * rsqrt(.) * (1 + scale)``."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return x * inv.to(dt) * (1.0 + scale.to(dt))


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over halves.  x: (..., s, h, hd), positions: (..., s)."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    freqs = torch.exp(
        -torch.log(torch.tensor(theta, **f32)) * torch.arange(half, **f32)
        / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., s, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def gated_mlp(x, wi, wo, act: str):
    """SwiGLU / GeGLU: wi: (d, 2, ff), wo: (ff, d).  x: (b, s, d)."""
    dt = x.dtype
    d, _, ff = wi.shape
    h = (x @ wi.to(dt).reshape(d, 2 * ff)).unflatten(-1, (2, ff))
    gate, up = h[..., 0, :], h[..., 1, :]
    g = F.gelu(gate, approximate="tanh") if act == "geglu" else F.silu(gate)
    return (g * up) @ wo.to(dt)


# ----------------------------------------------------------------- init
def init_linear(gen, shape, dtype, device, scale=0.02):
    """N(0, scale**2) drawn in f32 from ``gen`` on ``device``, then cast."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def init_norm(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def init_mlp(gen, d, ff, dtype, device, lead=()):
    """Gated-MLP weights; ``lead`` prefixes each shape (the layer axis)."""
    lead = tuple(lead)
    return {
        "wi": init_linear(gen, lead + (d, 2, ff), dtype, device),
        "wo": init_linear(gen, lead + (ff, d), dtype, device),
    }


def embed(tokens, table, dtype):
    """Token embedding with sqrt(d) scaling (gemma convention); the scale is
    taken in ``dtype`` (in bf16, sqrt(1152) is 34.0)."""
    d = table.shape[-1]
    scale = torch.tensor(d, dtype=dtype, device=table.device) ** 0.5
    return F.embedding(tokens, table.to(dtype)) * scale


def unembed(x, table):
    """Logits against the (tied) embedding table: (..., d) x (V, d) -> (..., V)."""
    return x @ table.to(x.dtype).T
