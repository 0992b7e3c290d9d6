"""Shared neural-net layers: RMSNorm, RoPE, gated MLPs, embeddings.

Plain functions over tensors and parameter dicts, in the reference's
layouts (``repro/models/layers.py``).  Every dtype is explicit, and each
rounds where the reference rounds: the norm's mean in f32, the rotary
angles in f32 cast to the activations' dtype, the embedding scale computed
in the compute dtype, GeGLU's GELU in its tanh form (``jax.nn.gelu``'s
default).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist.act_sharding import constrain, current_mesh, use_mesh

__all__ = [
    "remat",
    "sharded_last",
    "rms_norm",
    "rope",
    "gated_mlp",
    "init_linear",
    "init_norm",
    "init_mlp",
    "embed",
    "unembed",
]


# The ops whose outputs remat_policy="dots" keeps: the matmuls with no
# batch dims, which is what a matmul of a (b, s, d) activation by a 2-D
# weight lowers to.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def rms_norm(x, scale, eps: float = 1e-6):
    """Mean-square reduction in f32; the normalize and scale multiplies stay
    in the input dtype, ``x * rsqrt(.) * (1 + scale)``."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return x * inv.to(dt) * (1.0 + scale.to(dt))


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding over halves.  x: (..., s, h, hd), positions: (..., s).

    Positions expanded over the batch (stride 0: every row the same) give
    one row of tables that broadcasts against x: the same values, without
    a (b, s, hd) table per call (on a mesh, one per device)."""
    hd = x.shape[-1]
    half = hd // 2
    if (positions.ndim > 1 and positions.shape[0] > 1
            and not positions.stride(0)):
        positions = positions[:1]
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


def remat(fn, *args, policy: str = "nothing"):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant), by
    ``policy``, the config's ``remat_policy`` (the reference's
    ``_maybe_remat``): "nothing" saves nothing and recomputes the whole
    unit in the backward pass; "dots" saves the outputs of the matmuls
    with no batch dims (``_DOTS_SAVED``: the projections and the MLP, as
    ``dots_with_no_batch_dims_saveable`` does) and recomputes the rest,
    the attention's batched products included.  The recompute may run on
    the autograd engine's device thread, which does not see the forward's
    context, so on a mesh it re-enters the forward's mesh."""
    if policy == "dots":
        kw = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, list(_DOTS_SAVED))}
    elif policy == "nothing":
        kw = {}
    else:
        raise ValueError(f"remat_policy {policy!r}, expected 'nothing' or "
                         "'dots'")
    mesh = current_mesh()
    if mesh is None:
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    def on_mesh(*a):
        with use_mesh(mesh):
            return fn(*a)

    return checkpoint(on_mesh, *args, use_reentrant=False, **kw)


def sharded_last(w) -> bool:
    """Is ``w`` a DTensor split along its last axis?  Then (2, ff) cannot
    be flattened into one axis without gathering ff first."""
    return any(p.is_shard(w.ndim - 1) for p in getattr(w, "placements", ()))


def gated_mlp(x, wi, wo, act: str):
    """SwiGLU / GeGLU: wi: (d, 2, ff), wo: (ff, d).  x: (b, s, d).  With
    wi split along ff on a mesh the gate and up products run apart, each
    column-parallel."""
    dt = x.dtype
    d, _, ff = wi.shape
    w = wi.to(dt)
    if sharded_last(w):
        h = torch.stack([x @ w[:, 0], x @ w[:, 1]], dim=-2)
    else:
        h = (x @ w.reshape(d, 2 * ff)).unflatten(-1, (2, ff))
    h = constrain(h, "batch", None, None, "ff")
    gate, up = h[..., 0, :], h[..., 1, :]
    g = F.gelu(gate, approximate="tanh") if act == "geglu" else F.silu(gate)
    return constrain((g * up) @ wo.to(dt), "batch", None, None)


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
    taken in ``dtype`` (in bf16, sqrt(1152) is 34.0).  A table split along
    the vocabulary on a mesh is gathered for the lookup: DTensor's own
    sharded lookup yields a masked partial sum whose backward some torch
    versions cannot redistribute."""
    d = table.shape[-1]
    scale = torch.tensor(d, dtype=dtype, device=table.device) ** 0.5
    t = table.to(dtype)
    if any(p.is_shard() for p in getattr(t, "placements", ())):
        from torch.distributed.tensor import Replicate

        t = t.redistribute(t.device_mesh, [Replicate()] * len(t.placements))
    return constrain(F.embedding(tokens, t) * scale, "batch", None, None)


def unembed(x, table):
    """Logits against the (tied) embedding table: (..., d) x (V, d) -> (..., V).

    On a mesh the logits stay vocab-sharded."""
    logits = x @ table.to(x.dtype).T
    names = ["batch"] + [None] * (logits.ndim - 2) + ["vocab"]
    return constrain(logits, *names)
