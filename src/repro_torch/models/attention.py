"""Attention for the training forward: project, rotate, attend, project.

``attention`` computes what the reference's ``flash_attention`` computes
(``repro/models/attention.py``, ``_flash_fwd_chunks`` and its hand-written
VJP), over whole rows instead of chunks: q scaled by ``hd ** -0.5`` in q's
dtype before the dot, scores in f32, the causal mask ``j <= i`` and the
window mask ``j > i - window``, probabilities cast to v's dtype for the PV
product, the output ``acc / max(l, 1e-30)``, and under GQA query head ``h``
reading KV head ``h // (heads / kv)``.  The reference has no Pallas kernel
here; autograd over these matmuls is the backward pass.  The chunked online
softmax only bounds the reference's live memory; the full rows give the
same values up to the order of f32 sums (and, in bf16, where the
probabilities round).
"""
from __future__ import annotations

import torch

from .layers import init_linear, rope

__all__ = ["init_attn", "attention", "attn_forward"]

NEG_INF = -1e30


def init_attn(gen, d, heads, kv, hd, dtype, device, lead=()):
    """Projection weights; ``lead`` prefixes each shape (the layer axis)."""
    lead = tuple(lead)
    return {
        "wq": init_linear(gen, lead + (d, heads, hd), dtype, device),
        "wk": init_linear(gen, lead + (d, kv, hd), dtype, device),
        "wv": init_linear(gen, lead + (d, kv, hd), dtype, device),
        "wo": init_linear(gen, lead + (heads, hd, d), dtype, device),
    }


def attention(q, k, v, *, causal: bool = True, window=None):
    """q: (b, sq, h, hd); k, v: (b, skv, g, hd), h = g*r -> (b, sq, h, hd).

    ``window``: None for no sliding window, else W: attend to (i-W, i]."""
    b, sq, h, hd = q.shape
    _, skv, g, _ = k.shape
    r = h // g
    f32 = torch.float32
    qs = q * hd ** -0.5                                  # in q's dtype
    qg = qs.reshape(b, sq, g, r, hd).permute(0, 2, 3, 1, 4).to(f32)
    kg = k.permute(0, 2, 1, 3)[:, :, None].to(f32)      # (b, g, 1, skv, hd)
    s = qg @ kg.transpose(-1, -2)                        # (b, g, r, sq, skv)
    if causal or window is not None:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= j <= i
        if window is not None:
            mask &= j > i - window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    vg = v.permute(0, 2, 1, 3)[:, :, None].to(f32)
    acc = p.to(v.dtype).to(f32) @ vg                     # (b, g, r, sq, hd)
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def attn_forward(p, x, positions, *, heads, kv, hd, theta, causal=True,
                 window=None):
    """Project -> rope -> attend -> project.  x: (b, s, d)."""
    dt = x.dtype
    b, s, d = x.shape
    q = (x @ p["wq"].to(dt).reshape(d, heads * hd)).view(b, s, heads, hd)
    k = (x @ p["wk"].to(dt).reshape(d, kv * hd)).view(b, s, kv, hd)
    v = (x @ p["wv"].to(dt).reshape(d, kv * hd)).view(b, s, kv, hd)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    o = attention(q, k, v, causal=causal, window=window)
    return o.reshape(b, s, heads * hd) @ p["wo"].to(dt).reshape(heads * hd, d)
