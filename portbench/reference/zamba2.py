"""Plain PyTorch reference of Zamba2's published hybrid stack
(arXiv:2411.15242), written from the layer equations of transformers'
``models/zamba2/modeling_zamba2.py`` (4.57): its Mamba2 layers with B and C
in ``ssm_groups`` groups, and its hybrid layers, where one of
``n_mem_blocks`` shared attention+MLP blocks, taken in turn, reads
concat(hidden, embedding) and, through the layer's own linear, joins the
Mamba2 layer's input.

    shared(x, e) = MLP_k(norm2(attn(norm1([x, e]))))     no residual inside
    attn         = causal softmax(q k^T (hd / 2)^-0.5) v, RoPE on q and k,
                   q, k, v: 2 d -> heads x hd (= 2 d), out: 2 d -> d
    MLP_k(h)     = down(gelu(g) * u), [g, u] = h W_gu + (h A_k) B_k
    hybrid layer = x + mamba(norm(x + shared(x, e) L_k))
    mamba layer  = x + mamba(norm(x))

The port's stack conventions, which the published model does not share:
the embedding scaled by sqrt(d) (e is that scaled output), and every norm
scale applied as 1 + w.  dt is not clamped below (the published CUDA path,
``time_step_limit`` None; the plain torch path clamps it at
``time_step_min``).  f32 with every product through ``mm`` but the SSD
core's (``model.ssd``, f32 in the program too); each layer recomputed in
the backward (``model.recomputed``).  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model as blocks

__all__ = ["mamba2_grouped", "mamba_layer", "attention", "shared_block",
           "hybrid_layer", "stack", "logits"]


def mamba2_grouped(P, m, u, mm):
    """A Mamba2 mixer with B and C in G groups: heads g h/G ..
    (g + 1) h/G - 1 read group g, and the gated norm is taken over each
    group's d_inner / G channels."""
    d_in = m["ssm_expand"] * m["d_model"]
    p, n, G = m["ssm_headdim"], m["ssm_state"], m["ssm_groups"]
    h = d_in // p
    b, s, _ = u.shape
    z, xBC, dt = torch.split(mm(u, P["in_proj"]), [d_in, d_in + 2 * G * n, h],
                             dim=-1)
    xBC = blocks._conv_silu(xBC, P["conv_w"], P["conv_b"])
    x, B, C = torch.split(xBC, [d_in, G * n, G * n], dim=-1)
    x = x.reshape(b, s, h, p)
    dt = F.softplus(dt + P["dt_bias"])
    a = dt * -torch.exp(P["A_log"])
    X = x * dt[..., None]
    hg = h // G
    y = torch.cat([blocks.ssd(X[:, :, g * hg:(g + 1) * hg],
                              a[:, :, g * hg:(g + 1) * hg],
                              B[..., g * n:(g + 1) * n],
                              C[..., g * n:(g + 1) * n], m["ssm_chunk"])
                   for g in range(G)], dim=2)
    y = (y + P["D"][:, None] * x) * F.silu(z).reshape(b, s, h, p)
    y = blocks.rms_norm(y.reshape(b, s, G, d_in // G),
                        P["norm"].reshape(G, d_in // G), m["norm_eps"])
    return mm(y.reshape(b, s, d_in), P["out_proj"])


def mamba_layer(P, m, x, mm, t=None):
    """x + mamba(norm(x)), or with a shared block's output t:
    x + mamba(norm(x + t))."""
    inp = x if t is None else x + t
    return x + mamba2_grouped(P["mamba"], m,
                              blocks.rms_norm(inp, P["ln"], m["norm_eps"]),
                              mm)


def _rope(x, theta):
    """Rotary embedding over halves of (b, s, heads, hd), positions 0..s-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(P, m, h, mm):
    """The shared block's causal attention: (b, s, 2 d) -> (b, s, d)."""
    b, s, _ = h.shape
    H, kv, hd = m["n_heads"], m["n_kv"], m["head_dim"]

    def proj(w, n):
        return mm(h, w.reshape(w.shape[0], n * hd)).reshape(b, s, n, hd)

    q = _rope(proj(P["wq"], H), m["rope_theta"]).transpose(1, 2)
    k = _rope(proj(P["wk"], kv), m["rope_theta"]).transpose(1, 2)
    v = proj(P["wv"], kv).transpose(1, 2)
    k = k.repeat_interleave(H // kv, dim=1)
    v = v.repeat_interleave(H // kv, dim=1)
    scores = mm(q, k.transpose(-1, -2)) * (hd / 2) ** -0.5
    hidden = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(hidden, -math.inf), dim=-1)
    o = mm(probs, v).transpose(1, 2).reshape(b, s, H * hd)
    return mm(o, P["wo"].reshape(H * hd, -1))


def shared_block(P, adapter, m, x, e, mm):
    """A shared block over concat(x, e), with a hybrid layer's MLP adapter
    (A, B)."""
    eps = m["norm_eps"]
    h = blocks.rms_norm(torch.cat([x, e], dim=-1), P["ln1"], eps)
    h = blocks.rms_norm(attention(P["attn"], m, h, mm), P["ln2"], eps)
    wi = P["mlp"]["wi"]
    gu = mm(h, wi.reshape(wi.shape[0], -1)) + mm(mm(h, adapter[0]),
                                                  adapter[1])
    gate, up = gu.chunk(2, dim=-1)
    return mm(F.gelu(gate) * up, P["mlp"]["wo"])


def hybrid_layer(blk, hyb, pl, m, x, e, mm):
    """A hybrid layer: the shared block through the layer's linear into
    the Mamba2 layer's input."""
    t = mm(shared_block(blk, (hyb["adapter_a"], hyb["adapter_b"]), m, x, e,
                        mm), hyb["linear"])
    return mamba_layer(pl, m, x, mm, t)


def stack(params, m, e, mm):
    """The layers from the embedding's output e (b, s, d) to the final
    norm's input; each layer recomputed in the backward."""
    hyb = {i: k for k, i in enumerate(m["hybrid_layer_ids"])}
    x = e
    for i in range(m["n_layers"]):
        pl = blocks.layer(params["layers"], (i,))
        if i in hyb:
            k = hyb[i]
            x = blocks.recomputed(
                hybrid_layer,
                blocks.layer(params["blocks"], (k % m["n_mem_blocks"],)),
                blocks.layer(params["hybrid"], (k,)), pl, m, x, e, mm)
        else:
            x = blocks.recomputed(mamba_layer, pl, m, x, mm)
    return x


def logits(params, m, tokens, mm):
    """(b, s) tokens -> (b, s, V) logits, the embedding tied."""
    E = params["embed"]
    e = F.embedding(tokens, E) * math.sqrt(m["d_model"])
    x = stack(params, m, e, mm)
    x = blocks.rms_norm(x, params["final_norm"], m["norm_eps"])
    return mm(x, E.T)
