"""Decoder-only transformer stacks (the dense, moe and vlm families) and the
whisper-style encoder-decoder (encdec): init, the training forward,
prefill, decode and extend, as the reference's
``repro/models/transformer.py`` builds them.

Parameters keep the reference's tree, leaf names and shapes: the layers are
stacked on a leading L axis, as ``jax.vmap`` stacks them, so the gradient
codec's wire buffer holds the leaves in the reference's order.  The stack
is a Python loop over the layers, each reading its slice of the stacked
leaves; gemma3's 5:1 local:global pattern is a per-layer window.  The
training forward attends by ``cfg.attn_impl``, a prefill by the "scan"
route (``attention.flash_attention``).  With ``cfg.remat`` each training
layer runs under ``torch.utils.checkpoint`` and is recomputed in the
backward pass, but for what ``cfg.remat_policy`` keeps
(``layers.remat``).  The moe family's blocks hold a ``moe`` subtree in
place of ``mlp`` (``models/moe.py``), and the stack sums the blocks' aux
losses; the vlm family prepends ``batch["patches"]``
(b, P, d), cast to the compute dtype, to the embedded tokens of a training
forward or a prefill: the logits cover the text positions only, and the
cache holds the patches at positions 0..P-1.

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
write barrier.

On a mesh (``dist.act_sharding.use_mesh``) the parameters are DTensors
and the activations are placed at the reference's ``constrain`` sites; off
a mesh those calls return their argument.

The encdec half encodes ``batch["frames"]`` (b, F, d), the stub audio
frontend's embeddings, with non-causal blocks, and its decoder blocks add a
cross-attention to those states between the self-attention and the MLP;
its cache holds the decoder's ``k``/``v`` (L, b, S, g, hd), the encoder
states ``enc`` and ``len``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dist import _tree
from ..dist.act_sharding import constrain
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        init_attn, paged_targets, write_positions)
from .config import ModelConfig
from .layers import (embed, gated_mlp, init_linear, init_mlp, init_norm,
                     remat, rms_norm, unembed)
from .moe import init_moe, moe_forward

__all__ = ["NO_WINDOW", "global_flags", "layer_window", "init_dense_block",
           "init_decoder_only", "decoder_stack", "decoder_only_logits",
           "decoder_only_prefill", "decoder_only_decode",
           "decoder_only_extend", "init_encdec", "encode", "encdec_logits",
           "encdec_prefill", "encdec_decode"]

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
    """One block's parameters, an MoE FFN for the moe family; ``lead``
    prefixes each shape (the stacked layer axis)."""
    lead = tuple(lead)
    d = cfg.d_model
    p = {
        "ln1": init_norm(lead + (d,), dt, device),
        "attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.head_dim, dt,
                          device, lead),
        "ln2": init_norm(lead + (d,), dt, device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg, dt, device, lead)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, dt, device, lead)
    return p


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
    """The FFN half of a block: (x + FFN(norm(x)), the layer's aux loss,
    None for a dense FFN)."""
    h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_forward(pl["moe"], cfg, h2)
        return x + y, aux
    return x + gated_mlp(h2, pl["mlp"]["wi"], pl["mlp"]["wo"], cfg.act), None


def _seq_parallel(cfg: ModelConfig, x):
    """With ``seq_parallel`` the residual stream lives (batch x seq)-sharded
    between blocks on a mesh; the q/k/v and MLP placements pull whole
    sequences back in (the all-gather / reduce-scatter pair of sequence
    parallelism)."""
    return constrain(x, "batch", "seq", None) if cfg.seq_parallel else x


def _block(cfg: ModelConfig, pl, x, positions, window):
    x = _seq_parallel(cfg, x)
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attn_forward(pl["attn"], h, positions, window=window,
                         impl=cfg.attn_impl, **_attn_kwargs(cfg))
    return _mlp(cfg, pl, x)


def _cache_kv(kv):
    """A prefill's collected (k, v), placed as the cache holds them: heads
    over the model axis when divisible, else the sequence."""
    return tuple(constrain(t, "batch", "?seq", "kv", None) for t in kv)


def _block_kv(cfg: ModelConfig, pl, x, positions, window):
    x = _seq_parallel(cfg, x)
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    o, kv = attn_forward(pl["attn"], h, positions, window=window,
                         return_kv=True, impl="scan", **_attn_kwargs(cfg))
    return _mlp(cfg, pl, x + o)[0], _cache_kv(kv)


def _unstack(tree):
    """The trees of slice i of every stacked leaf of ``tree``, along the
    leading axis (the layer axis)."""
    leaves, spec = _tree.flatten(tree)
    per_layer = [leaf.unbind(0) for leaf in leaves]   # one backward stack
    return [_tree.unflatten(spec, [t[i] for t in per_layer])
            for i in range(len(per_layer[0]))]


def _layers(params):
    """The per-layer parameter trees of ``params["layers"]``."""
    return _unstack(params["layers"])


def decoder_stack(cfg: ModelConfig, params, x, positions, *,
                  collect_kv=False):
    """Run the layer stack.  Returns (x, aux_loss, kv): aux is the sum of
    the MoE layers' aux losses in layer order (0 for dense); kv is None, or
    with ``collect_kv`` the stacked (k, v), (L, b, s, g, hd) each, that a
    prefill writes into the cache."""
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pl, is_global in zip(_layers(params), global_flags(cfg)):
        window = layer_window(cfg, is_global)
        a = None
        if collect_kv:
            x, (k, v) = _block_kv(cfg, pl, x, positions, window)
            ks.append(k)
            vs.append(v)
        elif cfg.remat:
            x, a = remat(_block, cfg, pl, x, positions, window,
                         policy=cfg.remat_policy)
        else:
            x, a = _block(cfg, pl, x, positions, window)
        if a is not None:
            aux = aux + a
    return x, aux, ((torch.stack(ks), torch.stack(vs)) if collect_kv
                    else None)


def _embed_inputs(cfg: ModelConfig, params, batch):
    """The embedded tokens, behind the vlm family's patches: (x, P)."""
    dt = _dtype(cfg)
    x = embed(batch["tokens"], params["embed"], dt)
    if cfg.family != "vlm":
        return x, 0
    patches = batch["patches"].to(dt)
    return torch.cat([patches, x], dim=1), patches.shape[1]


def decoder_only_logits(cfg: ModelConfig, params, batch):
    """Training forward.  batch["tokens"]: (b, s) inputs; the vlm family's
    batch["patches"] (b, P, d) go before them.  Returns (logits over the
    text positions, aux); the unembedding is tied to ``embed``."""
    x, n_prefix = _embed_inputs(cfg, params, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x, aux, _ = decoder_stack(cfg, params, x, positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, n_prefix:], params["embed"]), aux


# ------------------------------------------------------------------ serving
def _pad_seq(t, pad: int):
    """Zero-pad axis 2 (the sequence axis of an (L, b, s, g, hd) stack);
    no op at all for no padding (torch 2.11's DTensor cannot plan a pad
    of a split sequence axis, and a prefill as long as its cache needs
    none)."""
    return F.pad(t, (0, 0, 0, 0, 0, pad)) if pad else t


def decoder_only_prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Prompt pass; returns (last-token logits, cache).

    Cache: {"k", "v"}: (L, b, S, g, hd) with S = cache_len, and "len".
    With cfg.window and cfg.window_cache the local layers keep only a
    W-slot ring (``_windowed_cache``); under cfg.kv_quant the cache is
    int8 with per-(layer, row, kv head) scales.  The vlm family's patches
    take positions 0..P-1 ahead of the prompt.
    """
    x, _ = _embed_inputs(cfg, params, batch)
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
    elif s % W:  # the last W tokens land at slots (s-W+i) mod W: a roll
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
        x, _ = _mlp(cfg, pl, x + o)
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
        x, _ = _mlp(cfg, pl, x + o)
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
        x, _ = _mlp(cfg, pl, x + o)
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


# ------------------------------------------------------------------ encdec
def init_encdec(gen, cfg: ModelConfig, device):
    """The whisper-style encoder-decoder: an encoder stack over the stub
    frames and a decoder stack whose blocks add a cross-attention."""
    dt = _pdtype(cfg)
    d, E, L = cfg.d_model, (cfg.enc_layers,), (cfg.n_layers,)

    def attn(lead):
        return init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.head_dim, dt,
                         device, lead)

    return {
        "embed": init_linear(gen, (cfg.vocab, d), dt, device),
        "enc_layers": {"ln1": init_norm(E + (d,), dt, device),
                       "attn": attn(E),
                       "ln2": init_norm(E + (d,), dt, device),
                       "mlp": init_mlp(gen, d, cfg.d_ff, dt, device, E)},
        "enc_norm": init_norm((d,), dt, device),
        "dec_layers": {"ln1": init_norm(L + (d,), dt, device),
                       "self_attn": attn(L),
                       "ln2": init_norm(L + (d,), dt, device),
                       "cross_attn": attn(L),
                       "ln3": init_norm(L + (d,), dt, device),
                       "mlp": init_mlp(gen, d, cfg.d_ff, dt, device, L)},
        "final_norm": init_norm((d,), dt, device),
    }


def _ffn(cfg: ModelConfig, ln, mlp, x):
    h = rms_norm(x, ln, cfg.norm_eps)
    return x + gated_mlp(h, mlp["wi"], mlp["wo"], cfg.act)


def _enc_block(cfg: ModelConfig, pl, x, positions):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attn_forward(pl["attn"], h, positions, causal=False,
                         impl=cfg.attn_impl, **_attn_kwargs(cfg))
    return _ffn(cfg, pl["ln2"], pl["mlp"], x)


def encode(cfg: ModelConfig, params, frames):
    """frames: (b, F, d) stub embeddings -> encoder states (b, F, d) in the
    compute dtype: non-causal self-attention blocks, then ``enc_norm``."""
    x = frames.to(_dtype(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    for pl in _unstack(params["enc_layers"]):
        if cfg.remat:
            x = remat(_enc_block, cfg, pl, x, positions,
                      policy=cfg.remat_policy)
        else:
            x = _enc_block(cfg, pl, x, positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block(cfg: ModelConfig, pl, x, positions, enc, collect_kv=False):
    """Self-attention (causal), cross-attention to ``enc``, MLP; with
    ``collect_kv`` also the self-attention's (k, v)."""
    akw = _attn_kwargs(cfg)
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    res = attn_forward(pl["self_attn"], h, positions, return_kv=collect_kv,
                       impl="scan" if collect_kv else cfg.attn_impl, **akw)
    o, kv = res if collect_kv else (res, None)
    if collect_kv:
        kv = _cache_kv(kv)
    x = x + o
    h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
    x = x + attn_forward(pl["cross_attn"], h2, positions, enc=enc,
                         impl=cfg.attn_impl, **akw)
    x = _ffn(cfg, pl["ln3"], pl["mlp"], x)
    return (x, kv) if collect_kv else x


def _dec_stack(cfg: ModelConfig, params, x, positions, enc, *,
               collect_kv=False):
    """The decoder stack.  Returns (x, kv): kv is None, or with
    ``collect_kv`` the stacked self-attention (k, v), (L, b, s, g, hd)
    each."""
    ks, vs = [], []
    for pl in _unstack(params["dec_layers"]):
        if collect_kv:
            x, (k, v) = _dec_block(cfg, pl, x, positions, enc, True)
            ks.append(k)
            vs.append(v)
        elif cfg.remat:
            x = remat(_dec_block, cfg, pl, x, positions, enc,
                      policy=cfg.remat_policy)
        else:
            x = _dec_block(cfg, pl, x, positions, enc)
    return x, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def _dec_inputs(cfg: ModelConfig, params, batch):
    """(encoder states, embedded tokens, their positions)."""
    enc = encode(cfg, params, batch["frames"])
    x = embed(batch["tokens"], params["embed"], _dtype(cfg))
    b, s, _ = x.shape
    return enc, x, torch.arange(s, device=x.device).expand(b, s)


def encdec_logits(cfg: ModelConfig, params, batch):
    """Training forward.  batch: "tokens" (b, s) and "frames" (b, F, d).
    Returns (logits, aux = 0)."""
    enc, x, positions = _dec_inputs(cfg, params, batch)
    x, _ = _dec_stack(cfg, params, x, positions, enc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (unembed(x, params["embed"]),
            torch.zeros((), dtype=torch.float32, device=x.device))


def encdec_prefill(cfg: ModelConfig, params, batch, cache_len: int):
    """Prompt pass; returns (last-token logits, cache): the decoder's
    self-attention ``k``/``v`` (L, b, S, g, hd) with S = cache_len, the
    encoder states ``enc`` (b, F, d) and ``len``."""
    enc, x, positions = _dec_inputs(cfg, params, batch)
    s = x.shape[1]
    pad = cache_len - s
    if pad < 0:
        raise ValueError("cache_len < prompt length")
    x, (k_new, v_new) = _dec_stack(cfg, params, x, positions, enc,
                                   collect_kv=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(x[:, -1:], params["embed"])[:, 0]
    return logits, {"k": _pad_seq(k_new, pad), "v": _pad_seq(v_new, pad),
                    "enc": enc, "len": s}


def encdec_decode(cfg: ModelConfig, params, cache, tokens, pos):
    """One decode step at the int position ``pos``: the self-attention K/V
    are written into the cache in place; the cross-attention reads the
    cached encoder states."""
    x = embed(tokens, params["embed"], _dtype(cfg))
    enc = cache["enc"]
    akw = _attn_kwargs(cfg)
    for i, pl in enumerate(_unstack(params["dec_layers"])):
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        o, _ = attn_decode(pl["self_attn"], h,
                           {"k": cache["k"][i], "v": cache["v"][i]}, pos,
                           **akw)
        x = x + o
        h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
        o2, _ = attn_decode(pl["cross_attn"], h2, None, pos, enc=enc, **akw)
        x = _ffn(cfg, pl["ln3"], pl["mlp"], x + o2)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x[:, 0], params["embed"]), dict(cache,
                                                   len=cache["len"] + 1)
