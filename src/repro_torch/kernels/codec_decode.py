"""Gradient-codec decode: the CUDA kernel ``csrc/codec_decode.cu`` and its
plain torch version.

Counterpart of ``src/repro/kernels/codec_decode.py::codec_decode_kernel_call``.
Both take the (nch, B) int32 per-channel sums, channel-major, and read the
n base rows only; with the host tables of the base (moduli ``m``, the
(n, n) table ``inv[j, i] = m_j^{-1} mod m_i``, and ``half``: the 15-bit
limbs of ceil(M/2) and of M) they return the (B,) f32 decoded values times
``inv_scale = 2**-frac_bits``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .common import barrett_mod, mrc_rows, recip

__all__ = ["codec_decode_kernel_call", "codec_decode_plain"]

_MASK = 0x7FFF


def codec_decode_plain(x_t, m, inv, half, *, inv_scale: float):
    """The kernel's function in plain torch (any device), op for op."""
    dev = x_t.device
    n = len(m)
    m = torch.as_tensor(np.asarray(m, np.int64), device=dev).to(torch.int32)
    inv = torch.as_tensor(np.asarray(inv, np.int64), device=dev).to(torch.int32)
    m_col = m[:, None]
    res = barrett_mod(x_t[:n].to(torch.int32), m_col, recip(m_col))   # fold
    digits = mrc_rows(res, inv, m)                                     # Alg. 2

    # Horner over the mixed radix, most significant digit first.
    l0 = digits[n - 1]
    l1 = torch.zeros_like(l0)
    l2 = torch.zeros_like(l0)
    for i in range(n - 2, -1, -1):
        mi = m[i]
        t0 = l0 * mi + digits[i]
        t1 = l1 * mi + (t0 >> 15)
        t2 = l2 * mi + (t1 >> 15)
        l0, l1, l2 = t0 & _MASK, t1 & _MASK, t2 & _MASK

    # signed fold: v >= T ? v - M : v, with borrows between the limbs
    t0c, t1c, t2c, m0c, m1c, m2c = (int(h) for h in half)
    ge = (l2 > t2c) | ((l2 == t2c) & ((l1 > t1c) | ((l1 == t1c) & (l0 >= t0c))))
    b0 = l0 - m0c
    bor0 = (b0 < 0).to(torch.int32)
    b1 = l1 - m1c - bor0
    bor1 = (b1 < 0).to(torch.int32)
    b2 = l2 - m2c - bor1
    s0 = torch.where(ge, b0 + (bor0 << 15), l0)
    s1 = torch.where(ge, b1 + (bor1 << 15), l1)
    s2 = torch.where(ge, b2, l2)

    # the f32 nearest the exact value: Fast2Sum of the exact limb terms
    a2 = s2.to(torch.float32) * float(1 << 30)
    a1 = s1.to(torch.float32) * float(1 << 15)
    a0 = s0.to(torch.float32)
    t1 = a2 + a1
    e1 = a1 - (t1 - a2)
    val = t1 + (e1 + a0)
    return val * inv_scale


def codec_decode_kernel_call(x_t, m, inv, half, *, inv_scale: float):
    """Launch ``csrc/codec_decode.cu`` on PyTorch's current stream (no sync).
    ``m`` (n,), ``inv`` (n, n) and ``half`` (6,) are host int tables."""
    m, inv, half = (np.ascontiguousarray(t, dtype=np.int32)
                    for t in (m, inv, half))
    n = len(m)
    if (x_t.dim() != 2 or x_t.shape[0] < n or inv.shape != (n, n)
            or half.shape != (6,)):
        raise ValueError(f"codec_decode: operand {tuple(x_t.shape)} or tables "
                         f"{inv.shape}, {half.shape} do not fit n={n}")
    B = x_t.shape[1]
    out = torch.empty(B, dtype=torch.float32, device=x_t.device)
    ptrs = (build.pointers("codec_decode", x_t)
            + build.pointers("codec_decode", out, dtype=torch.float32))
    if B == 0:
        return out
    with build.device_guard(x_t.device):
        err = build.load().rns_codec_decode(
            *ptrs, m.ctypes.data, inv.ctypes.data, half.ctypes.data, n,
            inv_scale, B, build.stream(x_t.device))
    build.check(err, "codec_decode")
    return out
