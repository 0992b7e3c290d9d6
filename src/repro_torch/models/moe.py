"""Mixture-of-Experts FFN with top-k routing and a per-row capacity: the
reference's ``repro/models/moe.py`` over tensors.

Dispatch is per row: each batch row sorts its own (token, expert)
assignments by expert (stably), ranks them within their expert, drops
those ranked at or past the row's capacity ``C``, and scatters the kept
tokens into a per-row expert buffer (b, E, C, d).  Rows never mix, so a
request's output does not depend on what shares its batch.  ``C`` depends
on the call's sequence length: a token's output depends on the chunk it
was computed in, and pads route and take capacity as real tokens do.

Two choices keep the reference's numbers where torch offers others:

- **Expert choice.**  ``jax.lax.top_k`` breaks ties to the lower expert
  index; ``torch.topk`` makes no promise about ties, so the top K are the
  first K of a stable descending sort.  The router runs in true f32
  (nothing in the port turns on TF32), since a rounded router flips
  experts that sit near a tie.
- **Combine.**  The reference scatter-adds each token's K weighted expert
  outputs in the compute dtype, in the order they sit in the sorted
  assignments: by ascending expert.  ``index_add_`` on the card adds them
  with atomics in a varying order, so the combine here gathers each
  token's K terms and adds them one at a time in ascending expert order,
  from zero, rounding after each add: the same sum, bit for bit, and the
  same on every run.

The expert products are the reference's batched products over all E
experts, the weights cast to the compute dtype per use.  Shared experts run
densely over every token.  The aux loss is the Switch-style load-balance
term, in f32, counting every token the call routes.

On a mesh the routing's sorts and ``searchsorted`` have no DTensor rule:
the block gathers its weights whole and runs as above on each device's
rows (``local_map``), without expert parallelism, and its aux loss is the
mean of the rows' shards' (the reference's is over the whole batch; on a
mesh of one device they are the same).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.act_sharding import constrain
from .layers import gated_mlp, init_linear

__all__ = ["init_moe", "capacity", "route", "dispatch", "combine",
           "moe_forward"]


def init_moe(gen, cfg, dtype, device, lead=()):
    """The MoE block's parameters (the reference's leaves and shapes); the
    router is f32 whatever ``dtype`` is.  ``lead`` prefixes each shape."""
    lead = tuple(lead)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_dff
    p = {
        "router": init_linear(gen, lead + (d, E), torch.float32, device),
        "wi": init_linear(gen, lead + (E, d, 2, f), dtype, device),
        "wo": init_linear(gen, lead + (E, f, d), dtype, device),
    }
    if cfg.n_shared:
        nf = cfg.n_shared * f
        p["shared_wi"] = init_linear(gen, lead + (d, 2, nf), dtype, device)
        p["shared_wo"] = init_linear(gen, lead + (nf, d), dtype, device)
    return p


def capacity(cfg, s: int) -> int:
    """The per-row capacity of each expert for a call of ``s`` tokens."""
    return max(1, int(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor))


def route(router, x, K: int):
    """Router probabilities and the top K of each token.  x: (b, s, d) ->
    (probs (b, s, E) f32, gates (b, s, K) f32 renormalized, idx (b, s, K)
    int64), the experts of a token in descending probability, ties to the
    lower index."""
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :K], idx[..., :K]
    return probs, gates / gates.sum(dim=-1, keepdim=True), idx


def dispatch(x, idx, gates, E: int, C: int):
    """The reference's ``_dispatch_row`` on every row.  x: (b, s, d); idx
    and gates: (b, s, K) -> (buf (b, E, C, d), dest, tok, w (b, s*K)): for
    the row's assignments in sorted-expert order, each one's slot
    ``e*C + rank`` in the buffer (``E*C``, the dump row, when dropped), its
    token, and its gate in x's dtype (0 when dropped)."""
    b, s, d = x.shape
    K = idx.shape[-1]
    dev = x.device
    sorted_e, order = torch.sort(idx.reshape(b, s * K), dim=-1, stable=True)
    experts = torch.arange(E, device=dev).expand(b, E).contiguous()
    seg_start = torch.searchsorted(sorted_e, experts, right=False)
    rank = (torch.arange(s * K, device=dev)
            - torch.gather(seg_start, 1, sorted_e))
    keep = rank < C
    tok = order // K
    dest = torch.where(keep, sorted_e * C + rank, E * C)
    rows = torch.arange(b, device=dev)[:, None]
    buf = x.new_zeros(b, E * C + 1, d)
    # every dropped assignment writes the dump row E*C: duplicate targets,
    # whichever lands is discarded with the row
    buf[rows, dest] = x[rows, tok]
    w = (torch.gather(gates.reshape(b, s * K), 1, order) * keep).to(x.dtype)
    return buf[:, : E * C].reshape(b, E, C, d), dest, tok, w


def combine(out_flat, dest, tok, w, s: int):
    """The reference's ``gather_row`` on every row, without atomics.
    out_flat: (b, E*C, d) expert outputs; dest, tok, w from ``dispatch`` ->
    y (b, s, d).  A token's K terms ``out[dest] * w`` are added one at a
    time, from zero, in the order the reference's scatter-add meets them:
    their positions in the sorted assignments, which is ascending expert.
    A dropped term is the zero row times a zero gate, +0, which adds
    nothing."""
    b, _, d = out_flat.shape
    K = tok.shape[1] // s
    rows = torch.arange(b, device=out_flat.device)[:, None]
    at = torch.sort(tok, dim=-1, stable=True).indices   # token-major
    padded = torch.cat([out_flat, out_flat.new_zeros(b, 1, d)], dim=1)
    terms = (padded[rows, torch.gather(dest, 1, at)]
             * torch.gather(w, 1, at)[..., None]).view(b, s, K, d)
    y = out_flat.new_zeros(b, s, d)
    for k in range(K):
        y = y + terms[:, :, k]
    return y


def moe_forward(p, cfg, x):
    """x: (b, s, d) -> (y (b, s, d), aux scalar f32)."""
    if hasattr(x, "placements"):
        return _moe_on_mesh(p, cfg, x)
    dt = x.dtype
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, s)
    probs, gates, idx = route(p["router"], x, K)

    # Switch-style aux loss: E * sum_e fraction_e * mean_prob_e
    onehot = F.one_hot(idx, E).to(torch.float32)         # (b, s, K, E)
    frac = onehot.sum(dim=2).mean(dim=(0, 1))
    aux = E * torch.sum(frac / K * probs.mean(dim=(0, 1)))

    buf, dest, tok, w = dispatch(x, idx, gates, E, C)
    # buf batch-sharded, expert weights model-sharded: the products below
    # are where the expert-parallel exchange happens on a mesh.  The
    # expert-major layouts keep the reference's claims ("batch" on the
    # data axes, "experts", else "ff", on the model axis).
    buf = constrain(buf, "batch", "experts", None, None)
    f = cfg.expert_dff
    xe = buf.transpose(0, 1).reshape(E, b * C, d)        # expert-major
    h = torch.bmm(xe, p["wi"].to(dt).reshape(E, d, 2 * f))
    h = constrain(h.view(E, b * C, 2, f), "experts", "batch", None, "ff")
    act = (lambda t: F.gelu(t, approximate="tanh")) if cfg.act == "geglu" \
        else F.silu
    h = act(h[..., 0, :]) * h[..., 1, :]
    out = torch.bmm(h, p["wo"].to(dt))                   # (E, b*C, d)
    out = constrain(out, "experts", "batch", None)
    out_flat = out.view(E, b, C, d).transpose(0, 1).reshape(b, E * C, d)
    y = combine(out_flat, dest, tok, w, s)
    if cfg.n_shared:   # gated_mlp places its hidden (b, s, 2, ff) by "ff"
        y = y + gated_mlp(x, p["shared_wi"], p["shared_wo"], cfg.act)
    return constrain(y, "batch", None, None), aux


def _moe_on_mesh(p, cfg, x):
    """``moe_forward`` of a DTensor x: the weights gathered whole, the block
    run on each device's shard of the batch rows (module docstring)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = [q if q.is_shard(0) else Replicate() for q in x.placements]
    whole = [Replicate()] * mesh.ndim
    aux_pl = [Partial("avg") if q.is_shard(0) else Replicate() for q in rows]
    keys = sorted(p)

    def block(xl, *ws):
        return moe_forward(dict(zip(keys, ws)), cfg, xl)

    return local_map(
        block, out_placements=(rows, aux_pl),
        in_placements=(rows, *[whole] * len(keys)), device_mesh=mesh)(
        x.redistribute(mesh, rows),
        *[p[k].redistribute(mesh, whole) for k in keys])
