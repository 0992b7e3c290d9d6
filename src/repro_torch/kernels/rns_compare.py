"""Fused Algorithm 1 (the paper's comparison): the CUDA kernel
``csrc/rns_compare.cu`` and its plain torch version.

Counterpart of ``src/repro/kernels/rns_compare.py::compare_kernel_call``.
Per column of channel-major (n, B) int32 operands:

    z      = (x1 - x2) mod m_i          channel-wise subtract
    digits = MRC(z)                     Alg. 2
    Delta  = to_ma(digits)              Alg. 3 dot against betas
    Delta' = (xa1 - xa2) mod m_a        redundant channel
    out    = (Delta == Delta')          (B,) int32 verdict, 1 where N1 >= N2
"""
from __future__ import annotations

import torch

from . import build
from .common import mrc_rows, to_ma_rows

__all__ = ["compare_kernel_call", "compare_plain"]


def compare_plain(x1_t, xa1, x2_t, xa2, inv, m, betas, ma: int):
    """The kernel's function in plain torch (any device)."""
    z = x1_t - x2_t
    z = torch.where(z < 0, z + m[:, None], z)
    delta = to_ma_rows(mrc_rows(z, inv, m), betas, ma)
    dp = xa1 - xa2
    dp = torch.where(dp < 0, dp + ma, dp)
    return (delta == dp).to(torch.int32)


def compare_kernel_call(x1_t, xa1, x2_t, xa2, inv, m, betas, ma: int):
    """Launch ``csrc/rns_compare.cu`` on PyTorch's current stream (no sync)."""
    n, B = x1_t.shape
    if (x2_t.shape != x1_t.shape or xa1.shape != (B,) or xa2.shape != (B,)
            or inv.shape != (n, n) or m.shape != (n,) or betas.shape != (n,)):
        raise ValueError("compare: operand or table shapes do not fit "
                         f"(n={n}, B={B})")
    out = torch.empty(B, dtype=torch.int32, device=x1_t.device)
    ptrs = build.pointers("compare", x1_t, xa1, x2_t, xa2, out, inv, m, betas)
    with torch.cuda.device(x1_t.device):
        err = build.load().rns_compare(*ptrs, int(ma), n, B,
                                       build.stream(x1_t.device))
    build.check(err, "compare")
    return out
