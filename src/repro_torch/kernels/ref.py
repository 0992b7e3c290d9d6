"""Plain torch oracles for the kernels, at the level of ``repro_torch.core``.

Each is the straight-line definition of the math a kernel must reproduce
bit-exactly, on channels-last ``(..., n)`` tensors, on any device.  Unlike
the core's public functions they never route to a kernel.
"""
from __future__ import annotations

from ..core import arith
from ..core.base import RNSBase
from ..core.compare import _compare_ge_impl
from ..core.convert import to_ma
from ..core.mrc import mrc

__all__ = ["ref_modmul", "ref_mrc", "ref_compare", "ref_to_ma"]


def ref_modmul(base: RNSBase, x, y):
    """(..., n) channel-wise modular product."""
    return arith.mul(base, x, y)


def ref_mrc(base: RNSBase, x):
    """(..., n) residues -> mixed-radix digits (Alg. 2)."""
    return mrc(base, x)


def ref_to_ma(base: RNSBase, digits):
    """(..., n) digits -> X mod m_a (Alg. 3)."""
    return to_ma(base, digits)


def ref_compare(base: RNSBase, x1, xa1, x2, xa2):
    """Alg. 1 verdict tensor (bool)."""
    return _compare_ge_impl(base, x1, xa1, x2, xa2)
