"""Decoder-only transformer stack (the dense family): init, the training
forward, prefill, decode and extend, as the reference's
``repro/models/transformer.py`` builds them.

Parameters keep the reference's tree, leaf names and shapes: the layers are
stacked on a leading L axis, as ``jax.vmap`` stacks them, so the gradient
codec's wire buffer holds the leaves in the reference's order.  The stack
is a Python loop over the layers, each reading its slice of the stacked
leaves; gemma3's 5:1 local:global pattern is a per-layer window.  With
``cfg.remat`` each training layer runs under ``torch.utils.checkpoint`` and
is recomputed in the backward pass.

The serving half keeps the reference's cache tree: ``k``/``v``
(L, b, S, g, hd) in the compute dtype, or int8 with ``ks``/``vs`` (L, b, g)
f32 scales under ``kv_quant``; gemma3's grouped layout under
``window_cache`` (``gk``/``gv`` for the global layers at full length,
``lk``/``lv`` rings of W slots for the local ones); and ``len``, a host
int (the reference's int32 scalar), so that no step waits for the card to
read it.  Decode and extend write the new K/V into the cache's tensors in
place and return a new dict over them.  With ``pages=``/``page_size=`` the
cache is a paged pool (``serve_step.paged_pool_zeros``: ``k``/``v``
(L, P, page_size, g, hd)) read and written through a page table
(``_paged_cache_stack``); ``valid_len=``/``scratch=`` are extend's padded
write barrier.  The MoE block comes with a later slice (ROADMAP.md,
queue 1).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..dist import _tree
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        init_attn, paged_targets, write_positions)
from .config import ModelConfig
from .layers import embed, gated_mlp, init_linear, init_mlp, init_norm, rms_norm, unembed

__all__ = ["NO_WINDOW", "global_flags", "layer_window", "init_dense_block",
           "init_decoder_only", "decoder_stack", "decoder_only_logits",
           "decoder_only_prefill", "decoder_only_decode",
           "decoder_only_extend"]

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
def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(heads=cfg.n_heads, kv=cfg.n_kv, hd=cfg.head_dim,
                theta=cfg.rope_theta)


def _mlp(cfg: ModelConfig, pl, x):
    h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + gated_mlp(h2, pl["mlp"]["wi"], pl["mlp"]["wo"], cfg.act)


def _block(cfg: ModelConfig, pl, x, positions, window):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attn_forward(pl["attn"], h, positions, window=window,
                         **_attn_kwargs(cfg))
    return _mlp(cfg, pl, x)


def _block_kv(cfg: ModelConfig, pl, x, positions, window):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    o, kv = attn_forward(pl["attn"], h, positions, window=window,
                         return_kv=True, **_attn_kwargs(cfg))
    return _mlp(cfg, pl, x + o), kv


def _layers(params):
    """The per-layer parameter trees: slice i of every stacked leaf."""
    leaves, spec = _tree.flatten(params["layers"])
    per_layer = [leaf.unbind(0) for leaf in leaves]   # one backward stack
    return [_tree.unflatten(spec, [t[i] for t in per_layer])
            for i in range(len(per_layer[0]))]


def decoder_stack(cfg: ModelConfig, params, x, positions, *,
                  collect_kv=False):
    """Run the layer stack.  Returns (x, aux_loss, kv): aux is 0 for dense;
    kv is None, or with ``collect_kv`` the stacked (k, v), (L, b, s, g, hd)
    each, that a prefill writes into the cache."""
    ks, vs = [], []
    for pl, is_global in zip(_layers(params), global_flags(cfg)):
        window = layer_window(cfg, is_global)
        if collect_kv:
            x, (k, v) = _block_kv(cfg, pl, x, positions, window)
            ks.append(k)
            vs.append(v)
        elif cfg.remat:
            x = checkpoint(_block, cfg, pl, x, positions, window,
                           use_reentrant=False)
        else:
            x = _block(cfg, pl, x, positions, window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def decoder_only_logits(cfg: ModelConfig, params, batch):
    """Training forward.  batch["tokens"]: (b, s) inputs.  Returns (logits,
    aux); the unembedding is tied to ``embed``."""
    dt = _dtype(cfg)
    x = embed(batch["tokens"], params["embed"], dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux, _ = decoder_stack(cfg, params, x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"]), aux


# ------------------------------------------------------------------ serving
def _pad_seq(t, pad: int):
    """Zero-pad axis 2 (the sequence axis of an (L, b, s, g, hd) stack)."""
    return F.pad(t, (0, 0, 0, 0, 0, pad))


def decoder_only_prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Prompt pass; returns (last-token logits, cache).

    Cache: {"k", "v"}: (L, b, S, g, hd) with S = cache_len, and "len".
    With cfg.window and cfg.window_cache the local layers keep only a
    W-slot ring (``_windowed_cache``); under cfg.kv_quant the cache is
    int8 with per-(layer, row, kv head) scales.
    """
    dt = _dtype(cfg)
    x = embed(batch["tokens"], params["embed"], dt)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, _, (k_new, v_new) = decoder_stack(cfg, params, x, positions,
                                         collect_kv=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x[:, -1:], params["embed"])[:, 0]
    pad = cache_len - s
    if pad < 0:
        raise ValueError("cache_len < prompt length")
    if cfg.window and cfg.window_cache:
        return logits, _windowed_cache(cfg, k_new, v_new, s, cache_len)
    cache = {"len": s}
    if cfg.kv_quant:
        if cfg.window:
            raise NotImplementedError("int8 KV + ring caches not combined")
        # per-(layer, batch, kv-head) symmetric int8 quantization
        f32 = torch.float32
        ks = torch.clamp(k_new.to(f32).abs().amax(dim=(2, 4)) / 127.0,
                         min=1e-6)
        vs = torch.clamp(v_new.to(f32).abs().amax(dim=(2, 4)) / 127.0,
                         min=1e-6)
        k_new = torch.clamp(torch.round(k_new / ks[:, :, None, :, None]),
                            -127, 127).to(torch.int8)
        v_new = torch.clamp(torch.round(v_new / vs[:, :, None, :, None]),
                            -127, 127).to(torch.int8)
        cache["ks"], cache["vs"] = ks, vs
    cache["k"] = _pad_seq(k_new, pad)
    cache["v"] = _pad_seq(v_new, pad)
    return logits, cache


def _windowed_cache(cfg: ModelConfig, k_new, v_new, s: int, cache_len: int):
    """Grouped cache for sliding-window archs (gemma3 5:1): the global
    layers keep the full sequence, the local layers a W-slot ring holding
    the last W tokens (the ring slot of position p is p mod W)."""
    W = cfg.window
    flags = global_flags(cfg)
    gidx = torch.as_tensor(np.nonzero(flags)[0], device=k_new.device)
    lidx = torch.as_tensor(np.nonzero(~flags)[0], device=k_new.device)
    pad = cache_len - s
    gk, gv = _pad_seq(k_new[gidx], pad), _pad_seq(v_new[gidx], pad)
    lk = k_new[lidx][:, :, max(0, s - W):]
    lv = v_new[lidx][:, :, max(0, s - W):]
    if s < W:  # short prompts: slots 0..s-1 are just positions 0..s-1
        lk, lv = _pad_seq(lk, W - s), _pad_seq(lv, W - s)
    else:      # the last W tokens land at slots (s-W+i) mod W: a roll
        lk = torch.roll(lk, s % W, dims=2)
        lv = torch.roll(lv, s % W, dims=2)
    return {"gk": gk, "gv": gv, "lk": lk, "lv": lv, "len": s}


def _windowed_decode(cfg: ModelConfig, params, cache, tokens, pos):
    """Decode over the grouped window caches: the local layers on the ring
    path, the global layers on the linear path.  ``pos``: one position for
    every row."""
    x = embed(tokens, params["embed"], _dtype(cfg))
    akw = _attn_kwargs(cfg)
    gk, gv, lk, lv = cache["gk"], cache["gv"], cache["lk"], cache["lv"]
    gi = li = 0
    for pl, is_global in zip(_layers(params), global_flags(cfg)):
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        if is_global:
            o, _ = attn_decode(pl["attn"], h, {"k": gk[gi], "v": gv[gi]},
                               pos, **akw)
            gi += 1
        else:
            o, _ = attn_decode(pl["attn"], h, {"k": lk[li], "v": lv[li]},
                               pos, ring=True, **akw)
            li += 1
        x = _mlp(cfg, pl, x + o)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x[:, 0], params["embed"])
    return logits, dict(cache, len=cache["len"] + 1)


def _linear_cache_stack(cfg: ModelConfig, params, cache, x, pos):
    """The layer stack over a linear (non-ring) KV cache, shared by the
    decode step and the chunked prefill-extend: x is (b, s, d), s >= 1 new
    tokens from position ``pos`` (an int, or one per row: see
    ``attention.write_positions``).  The positions are checked and moved to
    the card once for the whole stack.  Returns x after the final norm; the
    cache's K/V are written in place."""
    b, s, _ = x.shape
    pos = write_positions(pos, b, s, cache["k"].shape[2], x.device)
    akw = _attn_kwargs(cfg)
    quant = "ks" in cache
    for i, (pl, is_global) in enumerate(zip(_layers(params),
                                            global_flags(cfg))):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        if quant:
            layer_cache.update(ks=cache["ks"][i], vs=cache["vs"][i])
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        o, _ = attn_decode(pl["attn"], h, layer_cache, pos,
                           window=layer_window(cfg, is_global), **akw)
        x = _mlp(cfg, pl, x + o)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _paged_cache_stack(cfg: ModelConfig, params, pool, pages, x, pos,
                       page_size: int, valid_len=None, scratch=None):
    """The layer stack over the PAGED pool (the reference's DESIGN.md §13):
    ``pool``'s ``k``/``v`` are (L, P, page_size, g, hd), one buffer of
    physical pages that every slot shares, and ``pages`` ((b, n_pg)) maps
    each row's logical pages to physical ones.  The body is
    ``_linear_cache_stack``'s operation for operation (the same norms,
    residual order and attention on the gathered rows), so paged and
    monolithic layouts give the same activations bit for bit.  The
    positions are checked, and the page table and the write targets made,
    once for the whole stack.  Returns x after the final norm; the pool's
    K/V are written in place."""
    if "ks" in pool or "lk" in pool:
        raise ValueError("paged pools are linear and fp-only (no int8 KV, "
                         "no ring caches)")
    b, s, _ = x.shape
    dev = x.device
    pages = torch.as_tensor(pages, device=dev).to(torch.int64)
    S = pages.shape[1] * page_size
    pos = write_positions(pos, b, s, S, dev, valid_len)
    steps = torch.arange(s, device=dev)
    positions = (pos[:, None] + steps[None, :]
                 if isinstance(pos, torch.Tensor) else
                 (pos + steps).expand(b, s))
    targets = paged_targets(pages, positions, page_size, valid_len, scratch)
    akw = _attn_kwargs(cfg)
    for i, (pl, is_global) in enumerate(zip(_layers(params),
                                            global_flags(cfg))):
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        o, _, _ = attn_decode_paged(
            pl["attn"], h, pool["k"][i], pool["v"][i], pages, pos,
            page_size=page_size, window=layer_window(cfg, is_global),
            valid_len=valid_len, scratch=scratch, targets=targets, **akw)
        x = _mlp(cfg, pl, x + o)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def decoder_only_decode(cfg: ModelConfig, params, cache, tokens, pos,
                        pages=None, page_size=None):
    """One decode step.  tokens: (b, 1); pos: the new token's position, an
    int or one per row (continuous-batching slots).  With ``pages``/
    ``page_size`` the cache is a paged pool read and written through the
    page table."""
    if pages is not None:
        x = embed(tokens, params["embed"], _dtype(cfg))
        x = _paged_cache_stack(cfg, params, cache, pages, x, pos, page_size)
        logits = unembed(x[:, 0], params["embed"])
        return logits, dict(cache, len=cache["len"] + 1)
    if "lk" in cache:
        return _windowed_decode(cfg, params, cache, tokens, pos)
    x = embed(tokens, params["embed"], _dtype(cfg))
    x = _linear_cache_stack(cfg, params, cache, x, pos)
    logits = unembed(x[:, 0], params["embed"])
    return logits, dict(cache, len=cache["len"] + 1)


def decoder_only_extend(cfg: ModelConfig, params, cache, tokens, pos,
                        logit_index=None, pages=None, page_size=None,
                        valid_len=None, scratch=None):
    """Chunked prefill-extend: append a chunk of tokens to a linear cache.

    tokens: (b, C) land at positions pos..pos+C-1 (pos an int or one per
    row) with causal attention inside the chunk and full attention over
    the cache before it.  Returns (logits (b, C, V) over all C positions,
    cache); with ``logit_index`` (a chunk position) only that position is
    unembedded, (b, 1, V) — what the serve engine's admission reads.  Ring
    caches are not supported: serve lowers such archs to the masked
    linear layout.  With ``pages``/``page_size`` the chunk lands in a
    paged pool through the page table; ``valid_len``/``scratch`` (paged
    only, host ints) send each row's tokens from ``valid_len`` on to its
    ``scratch`` page instead — the padded write barrier of bucketed
    prefill over the pool.
    """
    if "lk" in cache:
        raise NotImplementedError(
            "extend over grouped ring caches is unsupported; build the "
            "cache with window_cache=False (full-length + window mask)"
        )
    x = embed(tokens, params["embed"], _dtype(cfg))
    if pages is not None:
        x = _paged_cache_stack(cfg, params, cache, pages, x, pos, page_size,
                               valid_len=valid_len, scratch=scratch)
    else:
        if valid_len is not None or scratch is not None:
            raise ValueError("the padded write barrier (valid_len=, "
                             "scratch=) is a paged-pool construct")
        x = _linear_cache_stack(cfg, params, cache, x, pos)
    if logit_index is not None:
        C = tokens.shape[1]
        if not 0 <= logit_index < C:
            raise ValueError(f"logit_index {logit_index} outside the chunk "
                             f"of {C}")
        x = x[:, logit_index:logit_index + 1]
    logits = unembed(x, params["embed"])
    return logits, dict(cache, len=cache["len"] + tokens.shape[1])
