"""Fused Algorithm 1 (the paper's comparison): the CUDA kernel
``csrc/rns_compare.cu`` and its plain torch version.

Counterpart of ``src/repro/kernels/rns_compare.py::compare_kernel_call``.
Per column of (n, B) int32 operands:

    z      = (x1 - x2) mod m_i          channel-wise subtract
    digits = MRC(z)                     Alg. 2
    Delta  = to_ma(digits)              Alg. 3 dot against betas
    Delta' = (xa1 - xa2) mod m_a        redundant channel
    out    = (Delta == Delta')          (B,) verdict, 1 where N1 >= N2

The kernel call keeps the reference's (n, B) signature but takes any (n,
B) and (B,) views and reads them where they lie, through their strides:
the divmod's packed (..., n+1) rows reach it with no copy.  It takes the
tables as the base's ``column_image`` (kernels/mrc.py).
"""
from __future__ import annotations

import torch

from . import build
from .common import mrc_rows, to_ma_rows
from .mrc import _layout_arg, check_image, launch_geometry

__all__ = ["compare_kernel_call", "compare_plain"]


def compare_plain(x1_t, xa1, x2_t, xa2, inv, m, betas, ma: int):
    """The kernel's function in plain torch (any device)."""
    z = x1_t - x2_t
    z = torch.where(z < 0, z + m[:, None], z)
    delta = to_ma_rows(mrc_rows(z, inv, m), betas, ma)
    dp = xa1 - xa2
    dp = torch.where(dp < 0, dp + ma, dp)
    return (delta == dp).to(torch.int32)


def compare_kernel_call(x1_t, xa1, x2_t, xa2, image, ma: int):
    """Launch ``csrc/rns_compare.cu`` on PyTorch's current stream (no sync).

    ``x1_t``, ``x2_t``: (n, B) int32 views on the card, ``xa1``, ``xa2``:
    (B,) int32 views, any strides; ``image``: the base's ``column_image``.
    Returns the (B,) verdicts as a bool tensor (the kernel writes a byte a
    verdict, so no cast follows the launch); the plain version's int32
    verdicts are the same values."""
    n, B = x1_t.shape
    if x2_t.shape != x1_t.shape or xa1.shape != (B,) or xa2.shape != (B,):
        raise ValueError("compare: operand shapes do not fit "
                         f"(n={n}, B={B})")
    dev = x1_t.device
    args = build.operands("compare", x1_t, xa1, x2_t, xa2)
    check_image("compare", image, n, dev)
    out = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out
    geometry = launch_geometry(n, B, dev)
    with build.device_guard(dev):
        err = build.load().rns_compare(*args, out.data_ptr(),
                                       image.data_ptr(), _layout_arg(n),
                                       int(ma), *geometry, B,
                                       build.stream(dev))
    build.check(err, "compare")
    return out
