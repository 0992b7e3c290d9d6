"""Attention: the training forward (project, rotate, attend, project) and
the cached decode path of the serve engine.

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

import numpy as np
import torch

from .layers import init_linear, rope

__all__ = ["init_attn", "attention", "attn_forward", "decode_attention",
           "decode_attention_ring", "attn_decode", "write_positions",
           "paged_targets", "attn_decode_paged"]

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


def _project(p, x, heads, kv, hd):
    """q, k, v projections of x: (b, s, d), in x's dtype."""
    dt = x.dtype
    b, s, d = x.shape
    q = (x @ p["wq"].to(dt).reshape(d, heads * hd)).view(b, s, heads, hd)
    k = (x @ p["wk"].to(dt).reshape(d, kv * hd)).view(b, s, kv, hd)
    v = (x @ p["wv"].to(dt).reshape(d, kv * hd)).view(b, s, kv, hd)
    return q, k, v


def _out(p, o):
    """The output projection of o: (b, s, h, hd)."""
    b, s, h, hd = o.shape
    wo = p["wo"].to(o.dtype)
    return o.reshape(b, s, h * hd) @ wo.reshape(h * hd, wo.shape[-1])


def attn_forward(p, x, positions, *, heads, kv, hd, theta, causal=True,
                 window=None, return_kv=False):
    """Project -> rope -> attend -> project.  x: (b, s, d).  With
    ``return_kv`` also the rotated keys and the values, (b, s, kv, hd)
    each: what a prefill writes into the cache."""
    q, k, v = _project(p, x, heads, kv, hd)
    q = rope(q, positions, theta)
    k = rope(k, positions, theta)
    out = _out(p, attention(q, k, v, causal=causal, window=window))
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
    """
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
    p = torch.softmax(s, dim=-1)
    vg = v_cache.to(cd).permute(0, 2, 1, 3)[:, :, None].to(f32)
    o = p.to(cd).to(f32) @ vg                             # (b, g, r, sq, hd)
    if vscale is not None:
        o = o * vscale[:, :, None, None, None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def decode_attention_ring(q, k_cache, v_cache, pos: int):
    """Sliding-window decode over a ring of W slots; the newest token was
    just written at slot pos mod W.  A slot holds logical position
    pos - ((pos - slot) mod W) (floor mod, as ``jnp.mod``); it is valid
    when that position is >= 0."""
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
    """
    if enc is not None:
        raise NotImplementedError(
            "cross-attention decode belongs to the encdec family, which is "
            "not ported yet (ROADMAP.md, queue 1)")
    b, s, _ = x.shape
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    if ring:
        if s != 1 or isinstance(pos, torch.Tensor) or np.ndim(pos) != 0:
            raise ValueError("ring caches decode one token at one host "
                             "position")
        start = int(pos)
    else:
        start = write_positions(pos, b, s, S, x.device)
    q, k_new, v_new = _project(p, x, heads, kv, hd)
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
    q, k_new, v_new = _project(p, x, heads, kv, hd)
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
