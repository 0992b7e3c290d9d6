"""Channel-wise modular multiply (the RNS ring product): the CUDA kernel
``csrc/modmul.cu`` and its plain torch version.

Counterpart of ``src/repro/kernels/modmul.py::modmul_kernel_call``.  Both
take channel-major (n, B) int32 reduced residues and (n,) moduli — n counts
redundant channels too, each row reducing in its own modulus.
"""
from __future__ import annotations

import torch

from . import build
from .common import barrett_mod, recip

__all__ = ["modmul_kernel_call", "modmul_plain"]


def modmul_plain(x_t, y_t, m):
    """The kernel's function in plain torch (any device)."""
    m_col = m[:, None]
    return barrett_mod(x_t * y_t, m_col, recip(m_col))


def modmul_kernel_call(x_t, y_t, m):
    """Launch ``csrc/modmul.cu`` on PyTorch's current stream (no sync)."""
    n, B = x_t.shape
    if y_t.shape != x_t.shape or m.shape != (n,):
        raise ValueError(f"modmul: shapes {tuple(x_t.shape)}, "
                         f"{tuple(y_t.shape)}, {tuple(m.shape)} do not fit")
    out = torch.empty_like(x_t)
    ptrs = build.pointers("modmul", x_t, y_t, out, m)
    with build.device_guard(x_t.device):
        err = build.load().rns_modmul(*ptrs, n, B, build.stream(x_t.device))
    build.check(err, "modmul")
    return out
