"""Attention: the training forward (project, rotate, attend, project) and
the cached decode path of the serve engine.

``flash_attention`` is the reference's chunked attention
(``repro/models/attention.py:48-322``): q_chunk x kv_chunk blocks under an
online softmax, so live memory is O(chunk²) rather than O(s²).  q is
scaled by ``hd ** -0.5`` in q's dtype, scores are f32 with the causal mask
``j <= i`` and the window mask ``j > i - window``, the running max, sum
and accumulator are f32, probabilities are cast to v's dtype for the PV
product, and the output is ``acc / max(l, 1e-30)``; under GQA query head
``h`` reads KV head ``h // (heads / kv)``.  Three routes, as the
reference's ``impl``:

* ``"vjp"`` (training): the forward visits only the KV chunks the causal
  mask and the window can reach (``kv_bounds``) and saves (q, k, v, out,
  lse); its hand-written backward recomputes each chunk's probabilities
  from ``lse`` (the reference's ``_flash_vjp_bwd``);
* ``"scan"`` (prefill): the same forward, which refuses a backward pass;
* ``"unrolled"`` (the reference's baseline): KV chunks ``0..qi`` whatever
  the window, which masks and does not skip, with autograd through the
  online softmax.

A length above the chunk that is not a whole number of chunks raises
``ValueError``, as the reference's asserts refuse it.  A fully visible
block is not masked (the mask would change nothing); the masks of the
others are made once a call for each offset between the chunks.  On a
mesh the chunk loop runs on each device's shard under ``local_map``
(batch and heads split, the sequence whole), so DTensor dispatches once a
call rather than once an op of the loop.

``attention`` is the plain version over whole rows: the same values up to
the order of f32 sums (and, in bf16, where the probabilities round), at an
(sq, skv) score block a head.  The tests and the chip smoke test hold the
routes against it; the models do not call it.  The reference has no
Pallas kernel here: the products are ``torch.matmul``.

``attn_forward(enc=)`` and ``attn_decode(enc=)`` are the encdec family's
cross-attention (``attention.py:325-353``, ``:446-452``): k and v
projected from the encoder states, rope on q only, no mask; decode
projects the encoder's K/V anew at every step, as the reference does.

Decode (``decode_attention``, ``decode_attention_ring``, ``attn_decode``)
attends one or more new tokens against a KV cache: a full-length cache with
a validity mask, or a ring buffer of W slots for a sliding-window layer, as
the reference's decode half does (``attention.py:354-499``).  The new K/V
are written into the cache tensors in place.  XLA clamps the start of a
``dynamic_update_slice`` that would run past the row; a torch index write
does not, and ``write_positions`` refuses such a write before it is made.

``attn_decode_paged`` is the same decode through a page table
(``attention.py:501-570``): the new K/V scatter to (page, offset) pairs of
a pooled buffer (``paged_targets``), and the logical rows are gathered back
out of the pool for ``decode_attention``.  The reference has no Pallas
kernel here either: the scatter and the gather are index ops.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dist.act_sharding import constrain
from .layers import init_linear, on_mesh, on_shards, rope, split_on

__all__ = ["init_attn", "attention", "flash_attention", "kv_bounds",
           "attn_forward", "decode_attention", "decode_attention_ring",
           "attn_decode", "write_positions", "paged_targets",
           "attn_decode_paged"]

NEG_INF = -1e30
IMPLS = ("vjp", "scan", "unrolled")


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

    ``window``: None for no sliding window, else W: attend to (i-W, i].
    On a mesh whose split of q's heads the KV groups cannot follow (8 KV
    heads on a 16-way axis) each KV head is repeated for its queries
    first (``_groups_for``)."""
    b, sq, h, hd = q.shape
    _, skv, g, _ = k.shape
    k, v = _groups_for(q, k, v)
    g = k.shape[2]
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


def _groups_for(q, k, v, *scales):
    """k, v (.., g, hd) (and per-group ``scales`` (b, g)) as the queries'
    grouping can take them: as they are, or, when q is a DTensor split
    along its heads over more ways than the g groups divide, each KV head
    repeated for its queries (one group a head: the same products)."""
    g, ways = k.shape[2], 1
    for dim, pl in enumerate(getattr(q, "placements", ())):
        if pl.is_shard(2):
            ways *= q.device_mesh.size(dim)
    if g % ways == 0:
        return (k, v, *scales)
    r = q.shape[2] // g
    return (k.repeat_interleave(r, dim=2), v.repeat_interleave(r, dim=2),
            *(s.repeat_interleave(r, dim=1) for s in scales))


# -------------------------------------------------------- chunked attention
def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    impl: str = "vjp"):
    """q: (b, sq, h, hd); k, v: (b, skv, g, hd), h = g*r -> (b, sq, h, hd).

    ``window``: None, or a host int W: attend to (i-W, i] (a global
    layer's ``NO_WINDOW`` reaches every chunk).  ``impl``: "vjp", "scan"
    or "unrolled" (module docstring).  The chunks are clamped to the
    lengths; a length that is not a whole number of them raises, and so
    does a causal call whose chunks or lengths differ."""
    sq, skv = q.shape[1], k.shape[1]
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"pad sequences to chunks: {sq} queries in chunks "
                         f"of {q_chunk}, {skv} keys in chunks of {kv_chunk}")
    if causal and (q_chunk != kv_chunk or sq != skv):
        raise ValueError(f"causal path assumes alignment: {sq} queries in "
                         f"chunks of {q_chunk}, {skv} keys in chunks of "
                         f"{kv_chunk}")
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}, expected one of {IMPLS}")
    run = functools.partial(_flash_local, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=kv_chunk, impl=impl)
    if hasattr(q, "device_mesh"):
        return _flash_on_mesh(run, q, k, v)
    return run(q, k, v)


def _flash_local(q, k, v, *, causal, window, q_chunk, kv_chunk, impl):
    if impl == "unrolled":
        return _flash_fwd_chunks(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk,
                                 skip=False)[0]
    route = _FlashVJP if impl == "vjp" else _FlashScan
    return route.apply(q, k, v, causal, window, q_chunk, kv_chunk)


def _flash_on_mesh(run, q, k, v):
    """``run`` on each device's shard: q's split of the batch and of the
    heads kept, any other placement replicated (the sequence stays whole,
    as in the reference's loop), k and v placed as q, their KV heads
    repeated first where the heads' split cannot follow the groups
    (``_groups_for``)."""
    from torch.distributed.tensor import Replicate

    k, v = _groups_for(q, k, v)
    pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
          for p in q.placements]     # a list: one output's placements
    return on_shards(run, q.device_mesh, [(t, pl, ()) for t in (q, k, v)],
                     pl)


def kv_bounds(qi: int, nk: int, *, causal: bool, window, q_chunk: int,
              kv_chunk: int) -> tuple[int, int]:
    """The KV chunks [lo, hi) that query chunk ``qi`` visits on the vjp
    and scan routes: up to the diagonal when causal, from the first chunk
    the window reaches (the reference's ``bounds``,
    ``attention.py:153-163``); every chunk when not causal."""
    if not causal:
        return 0, nk
    lo = 0 if window is None else max(0, (qi * q_chunk - window) // kv_chunk)
    return lo, qi + 1


def _hidden(masks: dict, qi, ki, q_chunk, kv_chunk, causal, window, device):
    """(q_chunk, kv_chunk) bool, True where a row of query chunk ``qi`` may
    not see a column of KV chunk ``ki``; None when it sees them all.
    ``masks`` keeps one a call for each offset between the chunks."""
    i0, j0 = qi * q_chunk, ki * kv_chunk
    if not ((causal and j0 + kv_chunk - 1 > i0) or (
            window is not None and j0 <= i0 + q_chunk - 1 - window)):
        return None
    off = j0 - i0
    if off not in masks:
        i = torch.arange(q_chunk, device=device)[:, None]
        j = torch.arange(kv_chunk, device=device)[None, :] + off
        bad = torch.zeros((q_chunk, kv_chunk), dtype=torch.bool,
                          device=device)
        if causal:
            bad |= j > i
        if window is not None:
            bad |= j <= i - window
        masks[off] = bad
    return masks[off]


def _rows(t, chunk: int, g: int, dtype):
    """(b, s, g*r, d) -> (s/chunk, b, g, r*chunk, d) in ``dtype``: each
    chunk's rows of one KV group's r query heads as one matrix."""
    b, s, h, d = t.shape
    r = h // g
    t = t.reshape(b, s // chunk, chunk, g, r, d).permute(1, 0, 3, 4, 2, 5)
    return t.to(dtype, memory_format=torch.contiguous_format).reshape(
        s // chunk, b, g, r * chunk, d)


def _unrows(t, g: int, chunk: int):
    """(b, g, r*chunk, d) -> (b, chunk, g*r, d), the inverse of one chunk
    of ``_rows``."""
    b, _, rc, d = t.shape
    r = rc // chunk
    return t.reshape(b, g, r, chunk, d).permute(0, 3, 1, 2, 4).reshape(
        b, chunk, g * r, d)


def _heads_major(t, dtype):
    """(b, s, g, d) -> (b, g, s, d) in ``dtype``, contiguous."""
    return t.permute(0, 2, 1, 3).to(dtype,
                                    memory_format=torch.contiguous_format)


def _mask(s, bad, r, q_chunk):
    """Scores (b, g, r*q_chunk, kv_chunk) with ``bad`` set to NEG_INF."""
    if bad is None:
        return s
    b, g, _, kc = s.shape
    return s.view(b, g, r, q_chunk, kc).masked_fill(bad, NEG_INF).view(
        b, g, r * q_chunk, kc)


def _flash_fwd_chunks(q, k, v, *, causal, window, q_chunk, kv_chunk,
                      skip=True):
    """The shared forward (the reference's ``_flash_fwd_chunks``): (out
    (b, sq, h, hd) in q's dtype, lse (b, g, r, sq) f32).  With ``skip``
    each query chunk visits ``kv_bounds``' chunks; without, every chunk up
    to the diagonal (the unrolled route).  Out of place throughout, so
    that autograd can run through it."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], k.shape[2]
    r = h // g
    nq, nk = sq // q_chunk, skv // kv_chunk
    f32, dev = torch.float32, q.device
    qs = _rows(q * hd ** -0.5, q_chunk, g, f32)      # scaled in q's dtype
    kf, vf = _heads_major(k, f32), _heads_major(v, f32)
    masks, outs, lses = {}, [], []
    for qi in range(nq):
        lo, hi = (kv_bounds(qi, nk, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=kv_chunk) if skip
                  else (0, qi + 1 if causal else nk))
        m = torch.full((b, g, r * q_chunk, 1), NEG_INF, dtype=f32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, g, r * q_chunk, hd), dtype=f32, device=dev)
        for ki in range(lo, hi):
            cols = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s = _mask(qs[qi] @ kf[:, :, cols].transpose(-1, -2),
                      _hidden(masks, qi, ki, q_chunk, kv_chunk, causal,
                              window, dev), r, q_chunk)
            m2 = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m2)
            corr = torch.exp(m - m2)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + p.to(v.dtype).to(f32) @ vf[:, :, cols]
            m = m2
        l = torch.clamp(l, min=1e-30)
        outs.append(_unrows(acc / l, g, q_chunk).to(q.dtype))
        lses.append((m + torch.log(l)).view(b, g, r, q_chunk))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _flash_bwd_chunks(q, k, v, out, lse, dout, *, causal, window, q_chunk,
                      kv_chunk):
    """The reference's ``_flash_vjp_bwd``: each visited chunk's
    probabilities recomputed from ``lse``, O(chunk²) live memory; dk and dv
    accumulated in f32 chunk by chunk; (dq, dk, dv) in their inputs'
    dtypes.

        delta_i = Σ_d dO_id · O_id
        p_ij    = exp(s_ij − lse_i)
        dv_j    = Σ_i p_ij dO_i          dp_ij = dO_i · v_j
        ds_ij   = p_ij (dp_ij − delta_i)
        dq_i    = scale Σ_j ds_ij k_j     dk_j = scale Σ_i ds_ij q_i

    As in the reference, s is the product of the unscaled q times scale."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], k.shape[2]
    r = h // g
    nq, nk = sq // q_chunk, skv // kv_chunk
    f32, dev = torch.float32, q.device
    scale = hd ** -0.5
    qs, dos = _rows(q, q_chunk, g, f32), _rows(dout, q_chunk, g, f32)
    deltas = _rows((dout.to(f32) * out.to(f32)).sum(-1, keepdim=True),
                   q_chunk, g, f32)                   # (nq, b, g, r*qc, 1)
    lses = lse.reshape(b, g, r, nq, q_chunk).permute(3, 0, 1, 2, 4).reshape(
        nq, b, g, r * q_chunk, 1)
    kf, vf = _heads_major(k, f32), _heads_major(v, f32)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    masks, dqs = {}, []
    for qi in range(nq):
        lo, hi = kv_bounds(qi, nk, causal=causal, window=window,
                           q_chunk=q_chunk, kv_chunk=kv_chunk)
        qb, dob = qs[qi], dos[qi]
        dq = torch.zeros_like(qb)
        for ki in range(lo, hi):
            cols = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kb, vb = kf[:, :, cols], vf[:, :, cols]
            s = _mask((qb @ kb.transpose(-1, -2)) * scale,
                      _hidden(masks, qi, ki, q_chunk, kv_chunk, causal,
                              window, dev), r, q_chunk)
            p = torch.exp(s - lses[qi])
            dv[:, :, cols] += p.transpose(-1, -2) @ dob
            ds = p * (dob @ vb.transpose(-1, -2) - deltas[qi])
            dq = dq + scale * (ds @ kb)
            dk[:, :, cols] += scale * (ds.transpose(-1, -2) @ qb)
        dqs.append(_unrows(dq, g, q_chunk))
    contiguous = torch.contiguous_format
    return (torch.cat(dqs, dim=1).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype, memory_format=contiguous),
            dv.permute(0, 2, 1, 3).to(v.dtype, memory_format=contiguous))


class _FlashVJP(torch.autograd.Function):
    """The vjp route: the chunked forward, saving (q, k, v, out, lse), and
    the hand-written chunked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _flash_fwd_chunks(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.flags = dict(causal=causal, window=window, q_chunk=q_chunk,
                         kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd_chunks(q, k, v, out, lse, dout, **ctx.flags),
                None, None, None, None)


class _FlashScan(torch.autograd.Function):
    """The scan route: the chunked forward; a gradient asked of it raises,
    as the reference's traced loop bounds refuse reverse mode."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        return _flash_fwd_chunks(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)[0]

    @staticmethod
    def backward(ctx, dout):
        raise RuntimeError("flash_attention(impl='scan') is forward only: "
                           "reverse-mode unsupported (use impl='vjp')")


def _project(p, x, src=None):
    """q, k, v projections, in x's dtype: q of x (b, s, d), k and v of
    ``src`` (b, t, d), x itself unless given (cross-attention)."""
    src = x if src is None else src
    return _proj(x, p["wq"]), _proj(src, p["wk"]), _proj(src, p["wv"])


def _proj(x, w):
    """x (b, s, d) times w (d, n, hd) -> (b, s, n, hd) in x's dtype; an x
    split along its sequence on a mesh projects on each device's shard
    (``_proj_on_mesh``)."""
    if split_on(x, 1):
        return _proj_on_mesh(x, w)
    b, s, d = x.shape
    n, hd = w.shape[1], w.shape[2]
    return (x @ w.to(x.dtype).reshape(d, n * hd)).view(b, s, n, hd)


def _proj_on_mesh(x, w):
    """``_proj`` of an x split along its sequence, on each device's shard
    under ``local_map``: torch 2.11's DTensor refuses the product's
    flattening of (b, s) when s is split ("Attempted to flatten multiple
    dimensions").  w keeps a split of its heads; x keeps its batch or
    sequence split where w is whole and is otherwise gathered whole; the
    output is split as both.  The gradients of x (over the heads' split)
    and of w (over x's) are partial sums on each shard, summed
    (``on_shards``)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    w_pl = [p if p.is_shard(1) else Replicate()
            for p in on_mesh(w, mesh).placements]
    x_pl = [Replicate() if pw.is_shard(1) else
            p if p.is_shard(0) or p.is_shard(1) else Replicate()
            for p, pw in zip(x.placements, w_pl)]
    out_pl = [Shard(2) if pw.is_shard(1) else px
              for px, pw in zip(x_pl, w_pl)]
    return on_shards(_proj, mesh, (
        (x, x_pl, [i for i, p in enumerate(w_pl) if p.is_shard(1)]),
        (w, w_pl, [i for i, p in enumerate(x_pl) if p.is_shard()])), out_pl)


def _out(p, o):
    """The output projection of o: (b, s, h, hd)."""
    b, s, h, hd = o.shape
    wo = p["wo"].to(o.dtype)
    return o.reshape(b, s, h * hd) @ wo.reshape(h * hd, wo.shape[-1])


def attn_forward(p, x, positions, *, heads, kv, hd, theta, causal=True,
                 window=None, enc=None, q_chunk=512, kv_chunk=512,
                 return_kv=False, impl="vjp"):
    """Project -> rope -> attend (``flash_attention`` by route ``impl``)
    -> project.  x: (b, s, d).  ``enc`` (b, F, d) switches to
    cross-attention against encoder states: k and v are projected from
    ``enc``, only q is rotated, and nothing is masked.  With ``return_kv``
    also the keys and the values, (b, s, kv, hd) each: what a prefill
    writes into the cache."""
    q, k, v = _project(p, x, src=enc)
    # heads claim 'model' when divisible; otherwise the batch spreads over
    # data AND model (batch-parallel attention)
    q = constrain(q, "?batch_plus", None, "heads", None)
    k = constrain(k, "?batch_plus", None, "kv", None)
    v = constrain(v, "?batch_plus", None, "kv", None)
    q = rope(q, positions, theta)
    if enc is None:
        k = rope(k, positions, theta)
    o = flash_attention(q, k, v, causal=causal and enc is None,
                        window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
                        impl=impl)
    o = constrain(o, "?batch_plus", None, "heads", None)
    out = constrain(_out(p, o), "batch", None, None)
    return (out, (k, v)) if return_kv else out


def decode_attention(q, k_cache, v_cache, cur_len, *, window=None,
                     kscale=None, vscale=None):
    """Cached attention for one or more appended tokens over a linear cache.

    q: (b, sq, h, hd); caches: (b, S, g, hd); ``cur_len``: the tokens in the
    cache, the newest included — an int, or a ``(b,)`` tensor when the rows
    sit at different positions (the continuous-batching slot layout).  Query
    i of sq lives at position cur_len - sq + i and attends to the positions
    j <= it (and j > it - window).  q is scaled in its own dtype and cast to
    the cache's; scores are f32; the probabilities are cast to the cache's
    dtype for the PV product.

    int8 caches pass kscale/vscale (b, g): q stays in its dtype, the cache
    is cast to it, and each scale multiplies after its contraction.

    Rows of q split along its heads on a mesh attend on each device's
    shard (``_decode_on_mesh``).
    """
    if split_on(q, 2) and q.shape[0] > 1:
        return _decode_on_mesh(q, k_cache, v_cache, cur_len, window=window,
                               kscale=kscale, vscale=vscale)
    if kscale is not None:
        k_cache, v_cache, kscale, vscale = _groups_for(q, k_cache, v_cache,
                                                       kscale, vscale)
    else:
        k_cache, v_cache = _groups_for(q, k_cache, v_cache)
    return _decode_rows(q, k_cache, v_cache, cur_len, window=window,
                        kscale=kscale, vscale=vscale)


def _decode_rows(q, k_cache, v_cache, cur_len, *, window, kscale, vscale,
                 jpos=None):
    """``decode_attention``'s arithmetic over cache positions ``jpos``
    (all S of them unless given).  Given them, a slice of the cache, it
    returns this slice's part: (o (b, sq, h, hd) in f32, normalised over
    the slice, and the log-sum-exp of its scores (b, sq, h)), which
    ``_merge_slices`` combines across slices."""
    b, S, g, hd = k_cache.shape
    sq, h = q.shape[1], q.shape[2]
    r = h // g
    f32 = torch.float32
    cd = q.dtype if kscale is not None else k_cache.dtype
    qg = (q.reshape(b, sq, g, r, hd) * hd ** -0.5).to(cd)
    qg = qg.permute(0, 2, 3, 1, 4).to(f32)                # (b, g, r, sq, hd)
    kg = k_cache.to(cd).permute(0, 2, 1, 3)[:, :, None].to(f32)
    s = qg @ kg.transpose(-1, -2)                         # (b, g, r, sq, S)
    if kscale is not None:
        s = s * kscale[:, :, None, None, None]
    dev = q.device
    part = jpos is not None
    if not part:
        jpos = torch.arange(S, device=dev)
    ipos = torch.arange(sq, device=dev)
    if isinstance(cur_len, torch.Tensor):
        qpos = cur_len.to(dev).reshape(-1, 1) - sq + ipos  # (b, sq)
    else:
        qpos = (int(cur_len) - sq + ipos)[None]           # (1, sq)
    mask = jpos[None, None, :] <= qpos[..., None]
    if window is not None:
        mask &= jpos[None, None, :] > qpos[..., None] - window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    if part:
        top = s.amax(-1, keepdim=True)
        e = torch.exp(s - top)
        total = e.sum(-1, keepdim=True)
        p = e / total
        lse = (top + total.log())[..., 0].permute(0, 3, 1, 2)
    else:
        p = torch.softmax(s, dim=-1)
    vg = v_cache.to(cd).permute(0, 2, 1, 3)[:, :, None].to(f32)
    o = p.to(cd).to(f32) @ vg                             # (b, g, r, sq, hd)
    if vscale is not None:
        o = o * vscale[:, :, None, None, None]
    o = o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    if part:
        return o, lse.reshape(b, sq, h)
    return o.to(q.dtype)


def _merge_slices(o, lse, dtype):
    """The slices' parts (``_decode_rows``), stacked on a leading axis:
    o (n, b, sq, h, hd), lse (n, b, sq, h), weighted by each slice's share
    of the softmax's total, summed, in ``dtype``."""
    w = torch.softmax(lse, dim=0)
    return (w[..., None] * o).sum(0).to(dtype)


def _decode_on_mesh(q, k, v, cur_len, *, window, kscale, vscale):
    """``decode_attention`` of a heads-split q on each device's shard under
    ``local_map``: torch 2.11's DTensor refuses the batched products'
    flattening of (b, g, r) when the groups are split and b is not 1 (a
    split dimension after the first that is not 1).

    A cache split along its sequence keeps that split, as flash decoding
    does: q is gathered whole over those mesh dimensions, each device
    attends over its slice of the positions (``_decode_rows``), and the
    slices' parts, a few numbers a row and head, are gathered and merged
    by their log-sum-exp (``_merge_slices``).  Elsewhere q's split of the
    batch and of the heads is kept and any other placement replicated; the
    caches, and the int8 scales, are placed as q, their KV heads repeated
    first where the heads' split cannot follow the groups
    (``_groups_for``); a per-row ``cur_len`` follows the batch.  Each
    (row, head) attends as on one device."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    keep = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in q.placements]
    seq = [i for i, p in enumerate(on_mesh(k, mesh).placements)
           if p.is_shard(1)]
    pl = [Replicate() if i in seq else p for i, p in enumerate(keep)]
    q = q.redistribute(mesh, pl)
    k, v, *scales = _groups_for(q, k, v, *(() if kscale is None
                                            else (kscale, vscale)))
    kv_pl = [Shard(1) if i in seq else p for i, p in enumerate(pl)]
    rows = [p if p.is_shard(0) else Replicate() for p in pl]   # (b,)
    groups = [Shard(1) if p.is_shard(2) else p for p in pl]     # (b, g)
    per_row = isinstance(cur_len, torch.Tensor)
    args = [(q, pl, ()), (k, kv_pl, ()), (v, kv_pl, ()),
            *([(cur_len, rows, ())] if per_row else []),
            *((sc, groups, ()) for sc in scales)]

    def attend(ql, kl, vl, *rest):
        n = rest[0] if per_row else cur_len
        ks, vs = rest[per_row:per_row + len(scales)] or (None, None)
        if not seq:
            return _decode_rows(ql, kl, vl, n, window=window, kscale=ks,
                                vscale=vs)
        o, lse = _decode_rows(ql, kl, vl, n, window=window, kscale=ks,
                              vscale=vs, jpos=rest[-1])
        return o[None], lse[None]

    if not seq:
        return on_shards(attend, mesh, args, pl)
    # the parts stacked on a new leading axis, split over the slices
    stack = [Shard(0) if i in seq else Shard(p.dim + 1) if p.is_shard()
             else p for i, p in enumerate(pl)]
    jpos = torch.arange(k.shape[1], device=k.device)
    o, lse = on_shards(attend, mesh, args + [
        (jpos, [Shard(0) if i in seq else Replicate()
                for i in range(mesh.ndim)], ())], (stack, stack))
    whole = [Replicate() if i in seq else p for i, p in enumerate(stack)]
    out = on_shards(functools.partial(_merge_slices, dtype=q.dtype), mesh,
                    ((o, whole, ()), (lse, whole, ())), pl)
    return out.redistribute(mesh, keep)


def decode_attention_ring(q, k_cache, v_cache, pos: int):
    """Sliding-window decode over a ring of W slots; the newest token was
    just written at slot pos mod W.  A slot holds logical position
    pos - ((pos - slot) mod W) (floor mod, as ``jnp.mod``); it is valid
    when that position is >= 0."""
    k_cache, v_cache = _groups_for(q, k_cache, v_cache)
    b, W, g, hd = k_cache.shape
    h = q.shape[2]
    r = h // g
    f32 = torch.float32
    dt = k_cache.dtype
    qg = (q.reshape(b, 1, g, r, hd) * hd ** -0.5).to(dt)
    qg = qg.permute(0, 2, 3, 1, 4).to(f32)
    kg = k_cache.permute(0, 2, 1, 3)[:, :, None].to(f32)
    s = qg @ kg.transpose(-1, -2)                         # (b, g, r, 1, W)
    slots = torch.arange(W, device=q.device)
    logical = pos - torch.remainder(pos - slots, W)
    s = s.masked_fill(logical < 0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vg = v_cache.permute(0, 2, 1, 3)[:, :, None].to(f32)
    o = p.to(dt).to(f32) @ vg
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(q.dtype)


def write_positions(pos, b: int, s: int, S: int, device, valid_len=None):
    """The first write position of each row, checked to lie in the row.

    ``pos``: an int (every row at one position) or one per row, as host
    data (a list, a numpy array or a CPU tensor) or a tensor on ``device``.
    Returns an int, or an int64 ``(b,)`` tensor on ``device``.  Host values
    are checked here: a write of s tokens from p needs 0 <= p and
    p + s <= S.  With ``valid_len`` (an int or one host int per row) only
    that many tokens of each row are real, and only they must fit: the
    pads after them are routed elsewhere (``paged_targets``).  A device
    tensor is not read back (that would wait for the card); torch's own
    index check refuses a write outside the row."""
    real = s if valid_len is None else np.asarray(valid_len, dtype=np.int64)
    if isinstance(pos, int) or (
            not isinstance(pos, torch.Tensor) and np.ndim(pos) == 0):
        p = int(pos)
        if p < 0 or p + int(np.max(real)) > S:
            raise ValueError(f"a write of {s} token(s) at position {p} "
                             f"leaves the cache row of {S} positions")
        return p
    if isinstance(pos, torch.Tensor) and pos.device != torch.device("cpu"):
        if tuple(pos.shape) != (b,):
            raise ValueError(f"per-row positions {tuple(pos.shape)}, "
                             f"expected ({b},)")
        return pos.to(device=device, dtype=torch.int64)
    host = torch.as_tensor(np.asarray(pos), dtype=torch.int64)
    if tuple(host.shape) != (b,):
        raise ValueError(f"per-row positions {tuple(host.shape)}, "
                         f"expected ({b},)")
    if b and (int(host.min()) < 0
              or int((host + torch.as_tensor(real)).max()) > S):
        raise ValueError(f"a write of {s} token(s) at positions "
                         f"{host.tolist()} leaves the cache rows of {S} "
                         f"positions")
    return host.to(device)


def attn_decode(p, x, cache, pos, *, heads, kv, hd, theta, ring=False,
                window=None, enc=None):
    """Cached decode for one block: one token, a chunk, per-row positions.

    cache: {"k": (b, S, g, hd), "v": ...} (S = W for a ring), optionally
    int8 with "ks"/"vs" (b, g) scales.  x: (b, s, d), s >= 1 new tokens a
    row; ``pos`` is the position of the FIRST new token — an int (every
    row aligned) or one per row (see ``write_positions``).  s > 1 is the
    chunked prefill-extend path: the tokens land at pos..pos+s-1 with
    causal attention inside the chunk.  A ring cache takes an int position
    and one token, written at slot pos mod W.  The new K/V are written
    into ``cache``'s tensors in place; returns (out, the cache dict).

    ``enc`` (b, F, d) is cross-attention: one token at one int position
    attends to all F encoder states, whose K/V are projected anew at every
    step, as the reference does; ``cache`` is returned as it came (None
    in the encdec stack).
    """
    b, s, _ = x.shape
    if enc is not None:
        if s != 1 or isinstance(pos, torch.Tensor) or np.ndim(pos) != 0:
            raise ValueError("cross-attention decode is one token at one "
                             "host position")
        q, k, v = _project(p, x, src=enc)
        q = rope(q, (int(pos) + torch.arange(1, device=x.device)).expand(
            b, 1), theta)
        return _out(p, decode_attention(q, k, v, k.shape[1])), cache
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    if ring:
        if s != 1 or isinstance(pos, torch.Tensor) or np.ndim(pos) != 0:
            raise ValueError("ring caches decode one token at one host "
                             "position")
        start = int(pos)
    else:
        start = write_positions(pos, b, s, S, x.device)
    q, k_new, v_new = _project(p, x)
    steps = torch.arange(s, device=x.device)
    if isinstance(start, torch.Tensor):
        positions = start[:, None] + steps[None, :]
    else:
        positions = (start + steps).expand(b, s)
    q = rope(q, positions, theta)
    k_new = rope(k_new, positions, theta)
    quant = "ks" in cache
    if quant:
        # the new token is quantized with the prefill's scales
        k_new = torch.clamp(torch.round(k_new / cache["ks"][:, None, :, None]),
                            -127, 127)
        v_new = torch.clamp(torch.round(v_new / cache["vs"][:, None, :, None]),
                            -127, 127)
    if isinstance(start, torch.Tensor):
        rows = torch.arange(b, device=x.device)[:, None]
        kc[rows, positions] = k_new.to(kc.dtype)
        vc[rows, positions] = v_new.to(vc.dtype)
    else:
        slot = start % S if ring else start
        kc[:, slot:slot + s] = k_new.to(kc.dtype)
        vc[:, slot:slot + s] = v_new.to(vc.dtype)
    if ring:
        o = decode_attention_ring(q, kc, vc, start)
    else:
        o = decode_attention(q, kc, vc, start + s, window=window,
                             kscale=cache.get("ks"), vscale=cache.get("vs"))
    out_cache = {"k": kc, "v": vc}
    if quant:
        out_cache["ks"], out_cache["vs"] = cache["ks"], cache["vs"]
    return _out(p, o), out_cache


def paged_targets(pages, positions, page_size: int, valid_len=None,
                  scratch=None):
    """The (physical page, in-page offset) each new token writes, two
    int64 ``(b, s)`` tensors: position p of row i lands at
    ``(pages[i, p // page_size], p % page_size)``.

    ``pages``: the ``(b, n_pg)`` int64 page table on the positions' device;
    ``positions``: ``(b, s)``.  With ``valid_len``/``scratch`` (host ints,
    or one per row) the tokens of row i from ``valid_len[i]`` on are pads:
    they go to the row's ``scratch`` page instead of through the table (the
    reference's padded write barrier), so a pad never lands in a mapped,
    shared or retained page.  A pad may sit past the logical row; its table
    lookup is clipped in bounds first, as the reference's is.  Two tokens
    of one call can share a target only on page 0 (idle rows park there)
    or on a scratch page, where what is written is never read.
    """
    n_pg = pages.shape[1]
    lp = torch.clamp(torch.div(positions, page_size, rounding_mode="floor"),
                     0, n_pg - 1)
    pid = torch.gather(pages, 1, lp)
    off = torch.remainder(positions, page_size)
    if valid_len is None:
        return pid, off
    b, s = positions.shape
    if np.ndim(valid_len) == 0 and np.ndim(scratch) == 0:
        pid[:, int(valid_len):] = int(scratch)
        return pid, off
    dev = positions.device
    valid = torch.as_tensor(np.broadcast_to(np.asarray(valid_len), (b,)),
                            dtype=torch.int64).to(dev)
    scr = torch.as_tensor(np.broadcast_to(np.asarray(scratch), (b,)),
                          dtype=torch.int64).to(dev)
    keep = torch.arange(s, device=dev)[None, :] < valid[:, None]
    return torch.where(keep, pid, scr[:, None]), off


def attn_decode_paged(p, x, k_pool, v_pool, pages, pos, *, page_size, heads,
                      kv, hd, theta, window=None, valid_len=None,
                      scratch=None, targets=None):
    """Cached decode through a page-table indirection (the reference's
    DESIGN.md §13).

    KV lives in a pooled buffer of fixed-size pages, ``k_pool``/``v_pool``
    (P, page_size, g, hd), and row i of ``pages`` ((b, n_pg), a tensor on
    x's device or host data) names the physical pages behind the row's
    logical positions 0..n_pg*page_size-1, in order; unmapped entries point
    at the parking page 0.  x: (b, s, d), s >= 1 new tokens a row from
    ``pos`` (an int, or one per row: ``write_positions``).  The new K/V
    project and rotate as in ``attn_decode`` and are written into the pool
    in place at ``paged_targets``; the logical rows are then gathered,
    ``k_pool[pages]`` as (b, n_pg*page_size, g, hd), and attended by
    ``decode_attention``.  The gathered row has the monolithic row's
    length and order, and what it holds past the written span sits behind
    the same mask, so the outputs are those of ``attn_decode`` on a
    monolithic cache bit for bit.

    ``valid_len``/``scratch`` (host ints) are the padded write barrier of
    bucketed prefill: only the first ``valid_len`` tokens of a row must lie
    in the row, and the rest are written to its ``scratch`` page.  Pad
    queries still attend; causal masking keeps every real query from a pad
    key.  ``targets`` passes ``paged_targets``' pair when a layer stack has
    made it once for all its layers (``pos`` then is the checked start).
    Returns (out, k_pool, v_pool).
    """
    b, s, _ = x.shape
    dev = x.device
    pages = torch.as_tensor(pages, device=dev).to(torch.int64)
    S = pages.shape[1] * page_size
    start = write_positions(pos, b, s, S, dev, valid_len)
    steps = torch.arange(s, device=dev)
    if isinstance(start, torch.Tensor):
        positions = start[:, None] + steps[None, :]
    else:
        positions = (start + steps).expand(b, s)
    q, k_new, v_new = _project(p, x)
    q = rope(q, positions, theta)
    k_new = rope(k_new, positions, theta)
    if targets is None:
        targets = paged_targets(pages, positions, page_size, valid_len,
                                scratch)
    pid, off = targets
    k_pool[pid, off] = k_new.to(k_pool.dtype)
    v_pool[pid, off] = v_new.to(v_pool.dtype)
    k_rows = k_pool[pages].reshape(b, S, kv, hd)
    v_rows = v_pool[pages].reshape(b, S, kv, hd)
    o = decode_attention(q, k_rows, v_rows, start + s, window=window)
    return _out(p, o), k_pool, v_pool
