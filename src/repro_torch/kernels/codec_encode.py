"""Gradient-codec encode: the CUDA kernel ``csrc/codec_encode.cu`` and its
plain torch version.

Counterpart of ``src/repro/kernels/codec_encode.py::codec_encode_kernel_call``.
Both take a flat (B,) f32 gradient row and the per-channel host tables of a
codec (moduli ``m``, ``pow15 = 2**15 mod m``, the negative-embedding shift
``off``: 0 on base rows, M mod m on redundant rows), and return the (nch, B)
int32 signed-embedded residues, channel-major.  A NaN encodes as 0, which is
what the reference's NaN-to-int conversion gives.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import barrett_mod, mod_mulhi, recip

__all__ = ["codec_encode_kernel_call", "codec_encode_plain"]


def _column(table, device):
    return torch.as_tensor(np.asarray(table, np.int64), device=device).to(
        torch.int32)[:, None]


def codec_encode_plain(g, m, pow15, off, *, scale: float, qh: int, ql: int):
    """The kernel's function in plain torch (any device), op for op."""
    m, pow15, off = (_column(t, g.device) for t in (m, pow15, off))
    r = torch.round(g.to(torch.float32) * scale)[None, :]   # half to even
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    neg = r < 0.0
    a = torch.clamp(r.abs(), max=float(1 << 44))
    hi_f = torch.floor(a * 2.0 ** -15)
    lo_f = a - hi_f * float(1 << 15)
    hi, lo = hi_f.to(torch.int32), lo_f.to(torch.int32)
    over = (hi > qh) | ((hi == qh) & (lo > ql))
    hi = torch.where(over, qh, hi)
    lo = torch.where(over, ql, lo)
    r_hi = mod_mulhi(hi, m)                                  # (nch, B)
    r_abs = barrett_mod(r_hi * pow15 + lo, m, recip(m))
    res = torch.where(r_abs > 0, m - r_abs, 0) + off
    res = torch.where(res >= m, res - m, res)
    return torch.where(neg, res, r_abs)


def codec_encode_kernel_call(g, m, pow15, off, *, scale: float, qh: int,
                             ql: int, out=None):
    """Launch ``csrc/codec_encode.cu`` on PyTorch's current stream (no sync).
    ``m``, ``pow15`` and ``off`` are host sequences of nch ints; ``out``,
    when given, the contiguous (nch, B) int32 tensor written."""
    tabs = [np.ascontiguousarray(t, dtype=np.int32) for t in (m, pow15, off)]
    nch = len(tabs[0])
    if g.dim() != 1 or any(t.shape != (nch,) for t in tabs):
        raise ValueError(f"codec_encode: a (B,) row and three (nch,) tables "
                         f"are needed, got {tuple(g.shape)} and "
                         f"{[t.shape for t in tabs]}")
    (B,) = g.shape
    if out is None:
        out = torch.empty((nch, B), dtype=torch.int32, device=g.device)
    elif tuple(out.shape) != (nch, B):   # dtype and device: ``pointers``
        raise ValueError(f"codec_encode: out is {tuple(out.shape)}, not "
                         f"({nch}, {B})")
    ptrs = (build.pointers("codec_encode", g, dtype=torch.float32)
            + build.pointers("codec_encode", out))
    if B == 0:
        return out
    with build.device_guard(g.device):
        err = build.load().rns_codec_encode(
            *ptrs, *(t.ctypes.data for t in tabs), nch, scale, qh, ql, B,
            build.stream(g.device))
    build.check(err, "codec_encode")
    return out
