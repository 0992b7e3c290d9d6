"""Model dispatcher: one API over the model families.

    init_params(cfg, generator, device)          -> parameter tree
    abstract_params(cfg)                         -> the same tree on "meta"
    train_logits(cfg, params, batch)             -> (logits, aux_loss)
    prefill(cfg, params, batch, cache_len)       -> (last_logits, cache)
    decode_step(cfg, params, cache, tokens, pos) -> (logits, cache)
    extend_step(cfg, params, cache, tokens, pos) -> (chunk_logits, cache)
    params_from_reference(cfg, tree, device)     -> the reference's params

A parameter tree is a nested dict of tensors with the reference's leaf
names and shapes (``repro.models.init_params``).  ``decode_step`` takes
per-row ``(b,)`` positions, and ``extend_step`` appends a whole token chunk
to a cache: together they carry the continuous-batching serve engine, on a
batched cache or, with ``pages=``/``page_size=``, on a paged pool.  The
three serving functions run under ``torch.inference_mode()`` and write the
new K/V into the cache's tensors in place.  The port runs the dense family;
the others (moe, vlm, ssm, hybrid, encdec) raise ``NotImplementedError``
until their slices land (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..dist import _tree
from . import transformer
from .config import ModelConfig

__all__ = ["init_params", "abstract_params", "train_logits", "prefill",
           "decode_step", "extend_step", "params_from_reference"]

_PORTED = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    cfg.validate()
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family of {cfg.name} is not ported yet "
            f"(ROADMAP.md, queue 1); the port runs {', '.join(_PORTED)}"
        )


def init_params(cfg: ModelConfig, generator=0, device="cuda"):
    """Random parameters: N(0, 0.02) weights in f32, cast to
    ``cfg.param_dtype``, and zero norm scales.  ``generator`` is a
    ``torch.Generator`` on ``device`` (a CPU one for "meta") or an int
    seed for a new one."""
    _check_family(cfg)
    device = torch.device(device)
    if not isinstance(generator, torch.Generator):
        gen_device = "cpu" if device.type == "meta" else device
        generator = torch.Generator(device=gen_device).manual_seed(generator)
    return transformer.init_decoder_only(generator, cfg, device)


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the "meta" device: shapes and dtypes, no
    allocation."""
    return init_params(cfg, 0, device="meta")


def train_logits(cfg: ModelConfig, params, batch):
    _check_family(cfg)
    return transformer.decoder_only_logits(cfg, params, batch)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, batch, cache_len: int):
    _check_family(cfg)
    return transformer.decoder_only_prefill(cfg, params, batch, cache_len)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                pages=None, page_size=None):
    _check_family(cfg)
    return transformer.decoder_only_decode(cfg, params, cache, tokens, pos,
                                           pages=pages, page_size=page_size)


@torch.inference_mode()
def extend_step(cfg: ModelConfig, params, cache, tokens, pos,
                logit_index=None, pages=None, page_size=None,
                valid_len=None, scratch=None):
    """Append a token chunk (b, C) at positions pos..pos+C-1 to a linear
    KV cache or a paged pool (``pages``, ``page_size``; ``valid_len``/
    ``scratch`` for padded chunks); returns (logits over all C positions —
    or just position ``logit_index`` when given — and the cache)."""
    _check_family(cfg)
    return transformer.decoder_only_extend(
        cfg, params, cache, tokens, pos, logit_index=logit_index,
        pages=pages, page_size=page_size, valid_len=valid_len,
        scratch=scratch)


def params_from_reference(cfg: ModelConfig, tree, device="cuda"):
    """The reference's parameters (its ``init_params`` output, leaves as
    numpy arrays or anything ``np.asarray`` takes) as the port's tree on
    ``device``.  The leaf names, shapes and dtypes must be those of
    ``abstract_params(cfg)``; a mismatch raises."""
    want = dict(_tree.flatten_named(abstract_params(cfg)))
    got = _tree.flatten_named(tree)
    if [name for name, _ in got] != list(want):
        raise ValueError(f"params_from_reference: leaves {[n for n, _ in got]}"
                         f", expected {list(want)}")
    leaves = []
    for name, leaf in got:
        a = np.asarray(leaf)
        if str(a.dtype) == "bfloat16":   # ml_dtypes: no numpy-native bf16
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        w = want[name]
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(
                f"params_from_reference: {name} is {tuple(t.shape)} "
                f"{t.dtype}, expected {tuple(w.shape)} {w.dtype}")
        leaves.append(t.to(device))
    return _tree.unflatten(_tree.flatten(tree)[1], leaves)
