"""SSM (mamba2) and hybrid (zamba2) stacks: init, the training forward,
prefill and decode, as the reference's ``repro/models/ssm_models.py``
builds them.

The hybrid follows Zamba2's shape: groups of ``attn_every`` Mamba2 layers,
each group followed by ONE attention+MLP block whose weights every group
shares, and the leftover layers as an attention-free tail.  The parameter
tree is the reference's: ``layers`` stacked on a leading L axis (ssm);
``groups`` stacked (G, g, ...), ``tail`` (T, ...) and ``shared`` (hybrid).
The shared block's gradient is the sum over its G uses, which autograd
forms.  With ``cfg.remat`` each remat unit runs under
``torch.utils.checkpoint``: a layer of the ssm stack; a whole group (its
Mamba2 layers and the shared block) and each tail layer of the hybrid, as
the reference's ``_maybe_remat`` sets them.

With ``cfg.hybrid_layer_ids`` set the hybrid is Zamba2's published layout
(arXiv:2411.15242; the port's own, the reference has none), trained only:
every layer is a Mamba2 layer, and hybrid layer k (the k-th of those
indices) first runs shared block ``k % n_mem_blocks`` over concat(x, e),
e the embedding's output: RMSNorm over 2 d, attention of heads x hd = 2 d
at softmax scale (hd / 2) ** -0.5 back to d, RMSNorm, an exact-GELU gated
MLP whose gate/up product adds the layer's own low-rank adapter, no
residual inside; then the layer's own d x d linear, whose output t joins
the Mamba2 layer's input, x + mamba(norm(x + t)).  The tree: ``layers``
(L, ...), ``hybrid`` {``adapter_a`` (H, d, r), ``adapter_b`` (H, r, 2 ff),
``linear`` (H, d, d)} and ``blocks`` (n_mem_blocks, ...); each layer is
one remat unit, and each block's gradient the sum over its uses.

The cache: ``ssm`` {"S" (L, b, h, ds, p) f32, "conv" (L, b, W - 1, c) in
the compute dtype} for the ssm family; for the hybrid ``groups`` with the
same leaves stacked (G, g, ...), ``tail`` (T, ...), and one KV slot a group,
``k``/``v`` (G, b, S, kv, hd); and ``len``, a host int.  Decode writes the
new states and K/V into the cache's tensors in place and returns a new dict
over them.
"""
from __future__ import annotations

import torch

from .attention import attn_decode, attn_forward, init_attn
from ..spans import traced
from .config import ModelConfig
from .layers import (embed, gated_mlp, init_linear, init_mlp, init_norm,
                     remat as _remat, rms_norm, unembed)
from .ssm import init_mamba2, mamba2_decode, mamba2_forward
from .transformer import (_attn_kwargs, _cache_kv, _dtype, _pad_seq, _pdtype,
                          _unstack)

__all__ = ["init_ssm_stack", "ssm_logits", "ssm_prefill", "ssm_decode",
           "hybrid_logits", "hybrid_prefill", "hybrid_decode"]


def _hybrid_split(cfg: ModelConfig):
    g = cfg.attn_every
    groups = cfg.n_layers // g
    tail = cfg.n_layers - groups * g
    return groups, g, tail


def _blk(gen, cfg: ModelConfig, dt, device, lead):
    return {"ln": init_norm(tuple(lead) + (cfg.d_model,), dt, device),
            "mamba": init_mamba2(gen, cfg, dt, device, lead)}


def init_ssm_stack(gen, cfg: ModelConfig, device):
    dt = _pdtype(cfg)
    p = {
        "embed": init_linear(gen, (cfg.vocab, cfg.d_model), dt, device),
        "final_norm": init_norm((cfg.d_model,), dt, device),
    }
    if cfg.family == "ssm":
        p["layers"] = _blk(gen, cfg, dt, device, (cfg.n_layers,))
        return p
    if cfg.published_hybrid:
        return dict(p, **_init_published(gen, cfg, dt, device))
    groups, g, tail = _hybrid_split(cfg)
    p["groups"] = _blk(gen, cfg, dt, device, (groups, g))
    if tail:
        p["tail"] = _blk(gen, cfg, dt, device, (tail,))
    d = cfg.d_model
    p["shared"] = {
        "ln1": init_norm((d,), dt, device),
        "attn": init_attn(gen, d, cfg.n_heads, cfg.n_kv, cfg.head_dim, dt,
                          device),
        "ln2": init_norm((d,), dt, device),
        "mlp": init_mlp(gen, d, cfg.d_ff, dt, device),
    }
    return p


def _init_published(gen, cfg: ModelConfig, dt, device):
    """The published hybrid layout's leaves (module docstring)."""
    d, ff, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    H, nb = len(cfg.hybrid_layer_ids), cfg.n_mem_blocks
    return {
        "layers": _blk(gen, cfg, dt, device, (cfg.n_layers,)),
        "hybrid": {
            "adapter_a": init_linear(gen, (H, d, r), dt, device),
            "adapter_b": init_linear(gen, (H, r, 2 * ff), dt, device),
            "linear": init_linear(gen, (H, d, d), dt, device),
        },
        "blocks": {
            "ln1": init_norm((nb, 2 * d), dt, device),
            "attn": init_attn(gen, 2 * d, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                              dt, device, (nb,), d_out=d),
            "ln2": init_norm((nb, d), dt, device),
            "mlp": init_mlp(gen, d, ff, dt, device, (nb,)),
        },
    }


# ----------------------------------------------------------------- forward
def _mamba(cfg: ModelConfig, pl, x):
    """One residual Mamba2 layer: (x + mamba(norm(x)), its state)."""
    o, st = mamba2_forward(pl["mamba"], cfg,
                           rms_norm(x, pl["ln"], cfg.norm_eps))
    return x + o, st


def _mamba_out(cfg: ModelConfig, pl, x):
    return _mamba(cfg, pl, x)[0]


def _mamba_stack(cfg: ModelConfig, stacked, x, *, remat=False):
    """Training forward through the layers of a stacked tree; each layer a
    remat unit with ``remat``."""
    for pl in _unstack(stacked):
        x = (_remat(_mamba_out, cfg, pl, x, policy=cfg.remat_policy)
             if remat else _mamba_out(cfg, pl, x))
    return x


def _mamba_states(cfg: ModelConfig, stacked, x):
    """Prefill through the layers of a stacked tree: (x, the states
    stacked as the layers are)."""
    Ss, convs = [], []
    for pl in _unstack(stacked):
        x, st = _mamba(cfg, pl, x)
        Ss.append(st["S"])
        convs.append(st["conv"])
    return x, {"S": torch.stack(Ss), "conv": torch.stack(convs)}


def _mamba_decode_into(cfg: ModelConfig, stacked, states, x):
    """One decode step through the layers of a stacked tree, each layer's
    new state written into its slice of ``states`` in place."""
    for i, pl in enumerate(_unstack(stacked)):
        h = rms_norm(x, pl["ln"], cfg.norm_eps)
        o, st = mamba2_decode(pl["mamba"], cfg, h,
                              {"S": states["S"][i],
                               "conv": states["conv"][i]})
        states["S"][i].copy_(st["S"])
        states["conv"][i].copy_(st["conv"])
        x = x + o
    return x


def _head(cfg: ModelConfig, params, x):
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def ssm_logits(cfg: ModelConfig, params, batch):
    x = embed(batch["tokens"], params["embed"], _dtype(cfg))
    x = _mamba_stack(cfg, params["layers"], x, remat=cfg.remat)
    return unembed(_head(cfg, params, x), params["embed"]), _zero_aux(x)


def ssm_prefill(cfg: ModelConfig, params, batch, cache_len: int):
    x = embed(batch["tokens"], params["embed"], _dtype(cfg))
    x, states = _mamba_states(cfg, params["layers"], x)
    logits = unembed(_head(cfg, params, x[:, -1:]), params["embed"])[:, 0]
    return logits, {"ssm": states, "len": batch["tokens"].shape[1]}


def ssm_decode(cfg: ModelConfig, params, cache, tokens, pos):
    x = embed(tokens, params["embed"], _dtype(cfg))
    x = _mamba_decode_into(cfg, params["layers"], cache["ssm"], x)
    return (unembed(_head(cfg, params, x)[:, 0], params["embed"]),
            dict(cache, len=cache["len"] + 1))


# ------------------------------------------------------------------ hybrid
def _shared_attn_fwd(cfg: ModelConfig, shared, x, positions, *,
                     collect_kv=False):
    """The shared attention+MLP block: the same weights at every call; with
    ``collect_kv`` also the call's (k, v), (b, s, kv, hd) each."""
    h = rms_norm(x, shared["ln1"], cfg.norm_eps)
    res = attn_forward(shared["attn"], h, positions, return_kv=collect_kv,
                       impl="scan" if collect_kv else cfg.attn_impl,
                       **_attn_kwargs(cfg))
    o, kv = res if collect_kv else (res, None)
    if collect_kv:
        kv = _cache_kv(kv)
    x = x + o
    h2 = rms_norm(x, shared["ln2"], cfg.norm_eps)
    x = x + gated_mlp(h2, shared["mlp"]["wi"], shared["mlp"]["wo"], cfg.act)
    return x, kv


def _group(cfg: ModelConfig, shared, gp, x, positions):
    """One group of the training forward: its Mamba2 layers, then the
    shared block."""
    x = _mamba_stack(cfg, gp, x)
    return _shared_attn_fwd(cfg, shared, x, positions)[0]


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


@traced("hybrid.attn")
def _shared_attn(cfg: ModelConfig, attn, h, positions):
    """The published block's attention: 2 d in, d out, (hd / 2) ** -0.5."""
    return attn_forward(attn, h, positions, impl=cfg.attn_impl,
                        scale=(cfg.head_dim / 2) ** -0.5, **_attn_kwargs(cfg))


@traced("hybrid.shared")
def _shared_block(cfg: ModelConfig, blk, adapter, x, e, positions):
    """A shared block of the published layout on layer input x and the
    embedding's output e, with a hybrid layer's MLP ``adapter`` (A, B): no
    residual inside (module docstring)."""
    h = rms_norm(torch.cat([x, e], dim=-1), blk["ln1"], cfg.norm_eps)
    h = rms_norm(_shared_attn(cfg, blk["attn"], h, positions), blk["ln2"],
                 cfg.norm_eps)
    return gated_mlp(h, blk["mlp"]["wi"], blk["mlp"]["wo"], cfg.act,
                     adapter=adapter)


def _hybrid_layer(cfg: ModelConfig, blk, hp, pl, x, e, positions):
    """A hybrid layer of the published layout: the shared block through
    the layer's linear joins the Mamba2 layer's input, not its residual."""
    t = _shared_block(cfg, blk, (hp["adapter_a"], hp["adapter_b"]), x, e,
                      positions) @ hp["linear"].to(x.dtype)
    o, _ = mamba2_forward(pl["mamba"], cfg,
                          rms_norm(x + t, pl["ln"], cfg.norm_eps))
    return x + o


def _published_logits(cfg: ModelConfig, params, batch):
    e = embed(batch["tokens"], params["embed"], _dtype(cfg))
    positions = _positions(e)
    blocks = _unstack(params["blocks"])
    hyb = {i: (k, hp) for k, (i, hp) in enumerate(
        zip(cfg.hybrid_layer_ids, _unstack(params["hybrid"])))}
    x = e
    for i, pl in enumerate(_unstack(params["layers"])):
        if i in hyb:
            k, hp = hyb[i]
            fn, args = _hybrid_layer, (blocks[k % cfg.n_mem_blocks], hp, pl,
                                       x, e, positions)
        else:
            fn, args = _mamba_out, (pl, x)
        x = (_remat(fn, cfg, *args, policy=cfg.remat_policy) if cfg.remat
             else fn(cfg, *args))
    return unembed(_head(cfg, params, x), params["embed"]), _zero_aux(x)


def _no_serving(cfg: ModelConfig):
    if cfg.published_hybrid:
        raise NotImplementedError(
            "the published Zamba2 hybrid layout (hybrid_layer_ids, "
            "n_mem_blocks, adapter_rank) trains only; it has no prefill or "
            "decode")


def hybrid_logits(cfg: ModelConfig, params, batch):
    if cfg.published_hybrid:
        return _published_logits(cfg, params, batch)
    x = embed(batch["tokens"], params["embed"], _dtype(cfg))
    positions = _positions(x)
    for gp in _unstack(params["groups"]):
        x = (_remat(_group, cfg, params["shared"], gp, x, positions,
                   policy=cfg.remat_policy)
             if cfg.remat else _group(cfg, params["shared"], gp, x,
                                      positions))
    if "tail" in params:
        x = _mamba_stack(cfg, params["tail"], x, remat=cfg.remat)
    return unembed(_head(cfg, params, x), params["embed"]), _zero_aux(x)


def hybrid_prefill(cfg: ModelConfig, params, batch, cache_len: int):
    _no_serving(cfg)
    x = embed(batch["tokens"], params["embed"], _dtype(cfg))
    s = x.shape[1]
    pad = cache_len - s
    if pad < 0:
        raise ValueError("cache_len < prompt length")
    positions = _positions(x)
    states, ks, vs = [], [], []
    for gp in _unstack(params["groups"]):
        x, st = _mamba_states(cfg, gp, x)
        x, (k, v) = _shared_attn_fwd(cfg, params["shared"], x, positions,
                                     collect_kv=True)
        states.append(st)
        ks.append(k)
        vs.append(v)
    cache = {"groups": {n: torch.stack([st[n] for st in states])
                        for n in ("S", "conv")},
             "len": s,
             "k": _pad_seq(torch.stack(ks), pad),   # (G, b, S, kv, hd)
             "v": _pad_seq(torch.stack(vs), pad)}
    if "tail" in params:
        x, cache["tail"] = _mamba_states(cfg, params["tail"], x)
    logits = unembed(_head(cfg, params, x[:, -1:]), params["embed"])[:, 0]
    return logits, cache


def hybrid_decode(cfg: ModelConfig, params, cache, tokens, pos):
    _no_serving(cfg)
    x = embed(tokens, params["embed"], _dtype(cfg))
    shared = params["shared"]
    for gi, gp in enumerate(_unstack(params["groups"])):
        gst = {n: cache["groups"][n][gi] for n in ("S", "conv")}
        x = _mamba_decode_into(cfg, gp, gst, x)
        h = rms_norm(x, shared["ln1"], cfg.norm_eps)
        o, _ = attn_decode(shared["attn"], h,
                           {"k": cache["k"][gi], "v": cache["v"][gi]}, pos,
                           **_attn_kwargs(cfg))
        x = x + o
        h2 = rms_norm(x, shared["ln2"], cfg.norm_eps)
        x = x + gated_mlp(h2, shared["mlp"]["wi"], shared["mlp"]["wo"],
                          cfg.act)
    if "tail" in params:
        x = _mamba_decode_into(cfg, params["tail"], cache["tail"], x)
    return (unembed(_head(cfg, params, x)[:, 0], params["embed"]),
            dict(cache, len=cache["len"] + 1))
