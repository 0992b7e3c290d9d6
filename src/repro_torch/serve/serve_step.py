"""Serving steps and the device state of the serve engine's lanes.

``make_prefill``/``make_decode_step`` wrap the model's serving functions
with the reference's fixed (params, batch) and (params, cache, tokens, pos)
signatures (``repro/serve/serve_step.py``).  ``prompt_zeros``,
``cache_zeros``, ``paged_pool_zeros`` and ``crypto_state_zeros`` are the
reference's ``prompt_abstract``, ``cache_abstract``,
``paged_pool_abstract`` and ``crypto_state_abstract`` made concrete:
torch has no abstract shapes to trace against, so the shapes are reckoned
from the configuration.

``Traced`` is the port's form of the reference's no-retrace census: the
reference counts the graphs ``jax.jit`` compiled for each engine function
(``_cache_size()``); a ``Traced`` function counts the distinct argument
signatures (tensor shapes, dtypes and devices; the type of anything else)
it was called with.  With fixed shapes every count stays 1.
"""
from __future__ import annotations

import torch

from ..models import decode_step, prefill
from ..models.ssm import _dims as _ssm_dims
from ..models.ssm_models import _hybrid_split
from ..models.transformer import _dtype, global_flags

__all__ = ["make_prefill", "make_decode_step", "prompt_zeros", "cache_zeros",
           "paged_pool_zeros", "crypto_state_zeros", "Traced"]


def make_prefill(cfg, cache_len: int):
    def fn(params, batch):
        return prefill(cfg, params, batch, cache_len)

    return fn


def make_decode_step(cfg):
    def fn(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)

    return fn


def prompt_zeros(cfg, batch: int, seq: int, device="cuda") -> dict:
    """An all-zero prompt batch of ``batch`` rows of ``seq`` tokens, with
    the stub inputs of its family (the reference's ``prompt_abstract``):
    ``patches`` (b, P, d) for vlm, ``frames`` (b, F, d) for encdec.

    >>> from repro_torch.configs import get_config
    >>> p = prompt_zeros(get_config("whisper-tiny").smoke(), 2, 8, "cpu")
    >>> {k: tuple(v.shape) for k, v in p.items()}
    {'tokens': (2, 8), 'frames': (2, 32, 128)}
    """
    out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32,
                                 device=device)}
    stub = {"vlm": ("patches", cfg.n_patches),
            "encdec": ("frames", cfg.enc_frames)}.get(cfg.family)
    if stub is not None:
        out[stub[0]] = torch.zeros((batch, stub[1], cfg.d_model),
                                   dtype=torch.float32, device=device)
    return out


def _ssm_state_zeros(cfg, lead: tuple, batch: int, zeros) -> dict:
    """Stacked Mamba2 states: S (*lead, b, h, ds, p) f32 and the conv ring
    (*lead, b, W - 1, c) in the compute dtype."""
    _, h, p, ds, conv_ch, _ = _ssm_dims(cfg)
    return {"S": zeros(*lead, batch, h, ds, p, dtype=torch.float32),
            "conv": zeros(*lead, batch, cfg.ssm_conv - 1, conv_ch)}


def cache_zeros(cfg, batch: int, cache_len: int, device="cuda") -> dict:
    """The all-zero decode cache of ``batch`` rows of ``cache_len``
    positions: the tree a prefill of ``cfg``'s family returns (the leaves
    and shapes of the reference's ``cache_abstract``), with ``len`` 0.
    The ssm family's holds the per-layer states (``ssm``), the hybrid's the
    groups' and the tail's states and one KV slot a group, encdec's the
    decoder's K/V and the encoder states (``enc``).

    >>> from repro_torch.configs import get_config
    >>> c = cache_zeros(get_config("gemma3-1b").smoke(), 2, 128, "cpu")
    >>> {k: tuple(v.shape) for k, v in c.items() if k != "len"}["lk"]
    (10, 2, 64, 1, 32)
    >>> c = cache_zeros(get_config("zamba2-1.2b").smoke(), 2, 128, "cpu")
    >>> tuple(c["groups"]["S"].shape), tuple(c["k"].shape)
    ((2, 6, 2, 16, 16, 16), (2, 2, 128, 2, 32))
    """
    cfg.validate()
    L, g, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    dt = _dtype(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family == "ssm":
        return {"ssm": _ssm_state_zeros(cfg, (L,), batch, zeros), "len": 0}
    if cfg.family == "hybrid":
        groups, per, tail = _hybrid_split(cfg)
        cache = {"groups": _ssm_state_zeros(cfg, (groups, per), batch, zeros),
                 "k": zeros(groups, batch, cache_len, g, hd),
                 "v": zeros(groups, batch, cache_len, g, hd), "len": 0}
        if tail:
            cache["tail"] = _ssm_state_zeros(cfg, (tail,), batch, zeros)
        return cache
    if cfg.family == "encdec":
        return {"k": zeros(L, batch, cache_len, g, hd),
                "v": zeros(L, batch, cache_len, g, hd),
                "enc": zeros(batch, cfg.enc_frames, cfg.d_model), "len": 0}

    if cfg.window and cfg.window_cache:
        n_global = int(global_flags(cfg).sum())
        n_local, W = L - n_global, cfg.window
        return {"gk": zeros(n_global, batch, cache_len, g, hd),
                "gv": zeros(n_global, batch, cache_len, g, hd),
                "lk": zeros(n_local, batch, W, g, hd),
                "lv": zeros(n_local, batch, W, g, hd), "len": 0}
    cache = {"len": 0}
    if cfg.kv_quant:
        if cfg.window:
            raise NotImplementedError("int8 KV + ring caches not combined")
        cache["ks"] = zeros(L, batch, g, dtype=torch.float32)
        cache["vs"] = zeros(L, batch, g, dtype=torch.float32)
        dt = torch.int8
    cache["k"] = zeros(L, batch, cache_len, g, hd, dtype=dt)
    cache["v"] = zeros(L, batch, cache_len, g, hd, dtype=dt)
    return cache


def paged_pool_zeros(cfg, n_pages: int, page_size: int,
                     device="cuda") -> dict:
    """The all-zero PAGED pool (the reference's DESIGN.md §13): k/v leaves
    of shape (L, n_pages, page_size, g, hd), and ``len``.  It is
    ``cache_zeros`` with the page pool standing in for the batch axis and
    one page for the sequence axis: pages are interchangeable fixed-size
    row fragments that a page table recomposes into logical rows when they
    are read.  Only the linear fp layout is paged (the serve engine lowers
    ring caches and refuses int8 ones).

    >>> from repro_torch.configs import get_config
    >>> p = paged_pool_zeros(get_config("gemma-2b").smoke(), 9, 8, "cpu")
    >>> tuple(p["k"].shape), p["len"]
    ((2, 9, 8, 1, 32), 0)
    """
    if cfg.window and cfg.window_cache:
        raise ValueError("a paged pool holds linear rows; build it with "
                         "window_cache=False (full-length + window mask)")
    if cfg.kv_quant:
        raise ValueError("paged pools are fp-only (no int8 KV)")
    return cache_zeros(cfg, n_pages, page_size, device)


def crypto_state_zeros(ctx, n_slots: int, device="cuda") -> dict:
    """All-zero device state of the crypto lane: one row per slot holding
    the Montgomery-ladder registers in both bases, the per-request channel
    constants of the modulus ``N`` (per-request DATA, so one kernel serves
    every modulus mix), and the fixed-width MSB-first exponent bit row the
    ladder consumes ``chunk`` at a time.

    ``ctx`` is a ``serve.crypto.CryptoContext`` (duck-typed: only
    ``nch_lo`` / ``n`` / ``n_hi`` / ``exp_bits`` are read).

    >>> from repro_torch.serve.crypto import CryptoContext
    >>> s = crypto_state_zeros(CryptoContext(n_limbs=3, exp_bits=8), 2, "cpu")
    >>> {k: tuple(v.shape) for k, v in s.items()}["r0_lo"]
    (2, 4)
    """
    row = lambda w: torch.zeros((n_slots, w), dtype=torch.int32,
                                device=device)
    return {
        "r0_lo": row(ctx.nch_lo), "r0_hi": row(ctx.n_hi),
        "r1_lo": row(ctx.nch_lo), "r1_hi": row(ctx.n_hi),
        "neg": row(ctx.n), "n_lo": row(ctx.nch_lo), "n_hi": row(ctx.n_hi),
        "bits": row(ctx.exp_bits),
    }


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


class Traced:
    """``fn`` with a census of the argument signatures it was called with.

    >>> f = Traced(lambda t, i: t[i])
    >>> _ = f(torch.zeros(3), 0), f(torch.zeros(3), 2)
    >>> f._cache_size()
    1
    >>> _ = f(torch.zeros(4), 0)
    >>> f._cache_size()
    2
    """

    def __init__(self, fn):
        self.fn = fn
        self.signatures: set = set()

    def __call__(self, *args):
        self.signatures.add(_signature(args))
        return self.fn(*args)

    def _cache_size(self) -> int:
        return len(self.signatures)
