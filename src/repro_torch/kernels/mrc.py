"""Batched Mixed-Radix Conversion (paper Alg. 2): the CUDA kernel
``csrc/mrc.cu`` and its plain torch version.

Counterpart of ``src/repro/kernels/mrc.py::mrc_kernel_call``.  Both take
channel-major (n, B) int32 residues, the (n, n) table
``inv[j, i] = m_j^{-1} mod m_i`` and the (n,) moduli, and return (n, B)
digits.  The kernel runs one column per thread with the column in shared
memory; see the source for its design.
"""
from __future__ import annotations

import torch

from . import build
from .common import mrc_rows

__all__ = ["mrc_kernel_call", "mrc_plain"]


def mrc_plain(x_t, inv, m):
    """The kernel's function in plain torch (any device)."""
    return mrc_rows(x_t, inv, m)


def mrc_kernel_call(x_t, inv, m):
    """Launch ``csrc/mrc.cu`` on PyTorch's current stream (no sync)."""
    n, B = x_t.shape
    if inv.shape != (n, n) or m.shape != (n,):
        raise ValueError(f"mrc: tables {tuple(inv.shape)}, {tuple(m.shape)} "
                         f"do not fit n={n}")
    out = torch.empty_like(x_t)
    ptrs = build.pointers("mrc", x_t, out, inv, m)
    with torch.cuda.device(x_t.device):
        err = build.load().rns_mrc(*ptrs, n, B, build.stream(x_t.device))
    build.check(err, "mrc")
    return out
