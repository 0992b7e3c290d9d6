"""Serving steps and the device state of the serve engine's lanes.

``make_prefill``/``make_decode_step`` wrap the model's serving functions
with the reference's fixed (params, batch) and (params, cache, tokens, pos)
signatures (``repro/serve/serve_step.py``).  ``cache_zeros``,
``paged_pool_zeros`` and ``crypto_state_zeros`` are the reference's
``cache_abstract``, ``paged_pool_abstract`` and ``crypto_state_abstract``
made concrete: torch has no abstract shapes to trace against, so the shapes
are reckoned from the configuration.

``Traced`` is the port's form of the reference's no-retrace census: the
reference counts the graphs ``jax.jit`` compiled for each engine function
(``_cache_size()``); a ``Traced`` function counts the distinct argument
signatures (tensor shapes, dtypes and devices; the type of anything else)
it was called with.  With fixed shapes every count stays 1.
"""
from __future__ import annotations

import torch

from ..models import decode_step, prefill
from ..models.model import _PORTED
from ..models.transformer import _dtype, global_flags

__all__ = ["make_prefill", "make_decode_step", "cache_zeros",
           "paged_pool_zeros", "crypto_state_zeros", "Traced"]


def make_prefill(cfg, cache_len: int):
    def fn(params, batch):
        return prefill(cfg, params, batch, cache_len)

    return fn


def make_decode_step(cfg):
    def fn(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)

    return fn


def cache_zeros(cfg, batch: int, cache_len: int, device="cuda") -> dict:
    """The all-zero decode cache of ``batch`` rows of ``cache_len``
    positions: the tree a prefill of the dense, moe or vlm family returns
    (the leaves and shapes of the reference's ``cache_abstract``), with
    ``len`` 0.

    >>> from repro_torch.configs import get_config
    >>> c = cache_zeros(get_config("gemma3-1b").smoke(), 2, 128, "cpu")
    >>> {k: tuple(v.shape) for k, v in c.items() if k != "len"}["lk"]
    (10, 2, 64, 1, 32)
    """
    cfg.validate()
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family of {cfg.name} is not ported yet "
            f"(ROADMAP.md, queue 1); the port runs {', '.join(_PORTED)}")
    L, g, hd = cfg.n_layers, cfg.n_kv, cfg.head_dim
    dt = _dtype(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

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
