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
new K/V (and the ssm families' states) into the cache's tensors in place.
All six families run: dense, moe and vlm (``transformer``), encdec
(``transformer``'s encoder-decoder half), ssm and hybrid
(``ssm_models``).  ``extend_step`` and a paged ``decode_step`` take the
text-only linear-KV ones (dense, moe), as the reference's do; an unknown
family raises ``ValueError``, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dist import _tree
from . import ssm_models, transformer
from .config import ModelConfig

__all__ = ["init_params", "abstract_params", "train_logits", "prefill",
           "decode_step", "extend_step", "params_from_reference"]

_DENSE = ("dense", "moe", "vlm")
_TEXT_ONLY = ("dense", "moe")   # the families extend and paging take


def _pick(cfg: ModelConfig, dense, encdec, ssm, hybrid):
    """The function of ``cfg``'s family."""
    if cfg.family in _DENSE:
        return dense
    fn = {"encdec": encdec, "ssm": ssm, "hybrid": hybrid}.get(cfg.family)
    if fn is None:
        raise ValueError(cfg.family)
    return fn


def init_params(cfg: ModelConfig, generator=0, device="cuda"):
    """Random parameters: N(0, 0.02) weights in f32, cast to
    ``cfg.param_dtype``, and zero norm scales (the Mamba2 blocks' decay,
    step and conv leaves as ``ssm.init_mamba2`` draws them).
    ``generator`` is a ``torch.Generator`` on ``device`` (a CPU one for
    "meta") or an int seed for a new one."""
    cfg.validate()
    device = torch.device(device)
    if not isinstance(generator, torch.Generator):
        gen_device = "cpu" if device.type == "meta" else device
        generator = torch.Generator(device=gen_device).manual_seed(generator)
    init = _pick(cfg, transformer.init_decoder_only, transformer.init_encdec,
                 ssm_models.init_ssm_stack, ssm_models.init_ssm_stack)
    return init(generator, cfg, device)


def abstract_params(cfg: ModelConfig):
    """The parameter tree on the "meta" device: shapes and dtypes, no
    allocation."""
    return init_params(cfg, 0, device="meta")


def train_logits(cfg: ModelConfig, params, batch):
    fn = _pick(cfg, transformer.decoder_only_logits,
               transformer.encdec_logits, ssm_models.ssm_logits,
               ssm_models.hybrid_logits)
    return fn(cfg, params, batch)


@torch.inference_mode()
def prefill(cfg: ModelConfig, params, batch, cache_len: int):
    fn = _pick(cfg, transformer.decoder_only_prefill,
               transformer.encdec_prefill, ssm_models.ssm_prefill,
               ssm_models.hybrid_prefill)
    return fn(cfg, params, batch, cache_len)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params, cache, tokens, pos,
                pages=None, page_size=None):
    """One decode step at ``pos`` (one position, or one per row on the
    linear-KV families); ``pages``/``page_size`` read and write a paged
    pool (dense, moe)."""
    if pages is not None and cfg.family not in _TEXT_ONLY:
        raise NotImplementedError(
            f"paged decode supports text-only linear-KV transformer "
            f"families (dense/moe), not {cfg.family}"
        )
    if cfg.family in _DENSE:
        return transformer.decoder_only_decode(
            cfg, params, cache, tokens, pos, pages=pages,
            page_size=page_size)
    fn = _pick(cfg, None, transformer.encdec_decode, ssm_models.ssm_decode,
               ssm_models.hybrid_decode)
    return fn(cfg, params, cache, tokens, pos)


@torch.inference_mode()
def extend_step(cfg: ModelConfig, params, cache, tokens, pos,
                logit_index=None, pages=None, page_size=None,
                valid_len=None, scratch=None):
    """Append a token chunk (b, C) at positions pos..pos+C-1 to a linear
    KV cache or a paged pool (``pages``, ``page_size``; ``valid_len``/
    ``scratch`` for padded chunks); returns (logits over all C positions —
    or just position ``logit_index`` when given — and the cache).  The vlm
    family is refused: its cache reserves positions 0..P-1 for the patches,
    which only a full prefill places."""
    if cfg.family not in _TEXT_ONLY:
        raise NotImplementedError(
            f"extend_step supports text-only linear-KV transformer families "
            f"(dense/moe), not {cfg.family}"
        )
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
