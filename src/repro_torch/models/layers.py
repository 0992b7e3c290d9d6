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


class _SumGrad(torch.autograd.Function):
    """Identity on a DTensor whose gradient each device computes as a
    partial sum over the mesh dimensions ``dims``: an operand of a product
    run on each shard under ``local_map`` while the other operand is split
    there (``local_map`` hands back a gradient placed as its input).  The
    backward sums it over those dimensions."""

    @staticmethod
    def forward(ctx, t, dims):
        ctx.dims, ctx.placements = dims, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial

        pl = [Partial() if i in ctx.dims else p
              for i, p in enumerate(ctx.placements)]
        g = DTensor.from_local(g.to_local(), g.device_mesh, pl,
                               run_check=False, shape=g.shape,
                               stride=g.stride())
        return g.redistribute(g.device_mesh, ctx.placements), None


def sum_grad_over(t, dims):
    """``t`` with its gradient summed over the mesh dimensions ``dims``
    (``_SumGrad``); ``t`` itself when there are none or no gradient is
    asked for."""
    if not dims or not torch.is_grad_enabled() or not t.requires_grad:
        return t
    return _SumGrad.apply(t, tuple(dims))


def split_on(t, dim: int) -> bool:
    """Is ``t`` a DTensor split along its axis ``dim``?"""
    return any(p.is_shard(dim) for p in getattr(t, "placements", ()))


def on_mesh(t, mesh):
    """``t`` as a DTensor on ``mesh``: itself when it is one, else a plain
    tensor (the same on every rank) replicated there."""
    if hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_shards(fn, mesh, args, out_placements):
    """``fn`` on each device's shard under ``local_map``.  ``args`` holds,
    for each of fn's arguments, ``(tensor, placements, dims)``: the tensor
    is put on ``mesh`` (``on_mesh``) and redistributed to its placements,
    and its gradient, a partial sum on each shard where another argument
    is split over the mesh dimensions ``dims``, is summed over them
    (``sum_grad_over``)."""
    from torch.distributed.tensor.experimental import local_map

    ts = [sum_grad_over(on_mesh(t, mesh).redistribute(mesh, pl), dims)
          for t, pl, dims in args]
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(pl for _, pl, _ in args),
                     device_mesh=mesh)(*ts)


def gated_mlp(x, wi, wo, act: str):
    """SwiGLU / GeGLU: wi: (d, 2, ff), wo: (ff, d).  x: (b, s, d).  With
    wi split along ff on a mesh the gate and up products run apart, each
    column-parallel; an x split along its sequence runs on each device's
    shard (``_mlp_on_mesh``)."""
    if split_on(x, 1):
        return constrain(_mlp_on_mesh(x, wi, wo, act), "batch", None, None)
    dt = x.dtype
    d, _, ff = wi.shape
    w = wi.to(dt)
    if split_on(w, 2):  # (2, ff) cannot flatten with ff split
        h = torch.stack([x @ w[:, 0], x @ w[:, 1]], dim=-2)
    else:
        h = (x @ w.reshape(d, 2 * ff)).unflatten(-1, (2, ff))
    h = constrain(h, "batch", None, None, "ff")
    gate, up = h[..., 0, :], h[..., 1, :]
    g = F.gelu(gate, approximate="tanh") if act == "geglu" else F.silu(gate)
    return constrain((g * up) @ wo.to(dt), "batch", None, None)


def _mlp_on_mesh(x, wi, wo, act: str):
    """``gated_mlp`` of an x split along its sequence, on each device's
    shard under ``local_map``: torch 2.11's DTensor refuses the products'
    flattening of (b, s) when s is split ("Attempted to flatten multiple
    dimensions").  wi and wo keep a split of ff; x keeps its batch or
    sequence split where they are whole and is otherwise gathered whole,
    and the output is then a partial sum over ff's split (row-parallel
    wo), reduced by the caller's placement.  Each shard runs the plain
    path's products.  The gradients of x (over ff's split) and of wi, wo
    (over x's) are partial sums on each shard, summed by
    ``sum_grad_over``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    wi_pl = [p if p.is_shard(2) else Replicate()
             for p in on_mesh(wi, mesh).placements]
    wo_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in wi_pl]
    x_pl = [Replicate() if pw.is_shard(2) else
            p if p.is_shard(0) or p.is_shard(1) else Replicate()
            for p, pw in zip(x.placements, wi_pl)]
    out_pl = [Partial() if pw.is_shard(2) else px
              for px, pw in zip(x_pl, wi_pl)]
    by_ff = [i for i, p in enumerate(wi_pl) if p.is_shard(2)]
    by_x = [i for i, p in enumerate(x_pl) if p.is_shard()]
    return on_shards(functools.partial(gated_mlp, act=act), mesh,
                     ((x, x_pl, by_ff), (wi, wi_pl, by_x),
                      (wo, wo_pl, by_x)), out_pl)


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
