"""Channel-wise RNS arithmetic on batched residue tensors.

Residue tensors have shape ``(..., n)`` — the trailing axis is the RNS
channel axis.  All ops are exact ring operations mod m_i per channel.

``jnp.mod`` in the reference is floor-mod; its counterpart here is
``torch.remainder`` (never ``torch.fmod``).  Tables are cast to the operand's
dtype, since torch has no global x64 switch to promote them.

Overflow discipline (the reason ``bits<=15`` ⇒ int32 lanes is safe):
  * add/sub intermediates are in (-m, 2m) ⊂ int32,
  * products of two reduced residues are < 2**30.
"""
from __future__ import annotations

import torch

from .base import RNSBase

__all__ = ["add", "sub", "mul", "neg", "mul_const", "modt"]


def _m(base: RNSBase, like):
    return base.tensor("moduli_np", like.device, like.dtype)


def modt(base: RNSBase, x):
    """Reduce an (over-ranged but in-dtype) tensor channel-wise mod m_i."""
    return torch.remainder(x, _m(base, x))


def add(base: RNSBase, x, y):
    m = _m(base, x)
    s = x + y
    return torch.where(s >= m, s - m, s)


def sub(base: RNSBase, x, y):
    m = _m(base, x)
    d = x - y
    return torch.where(d < 0, d + m, d)


def neg(base: RNSBase, x):
    m = _m(base, x)
    return torch.where(x == 0, x, m - x)


def mul(base: RNSBase, x, y):
    """Product of reduced residues; fits the lane dtype by construction."""
    return torch.remainder(x * y, _m(base, x))


def mul_const(base: RNSBase, x, c):
    """x * c with c a per-channel constant vector (n,) of reduced residues."""
    c = torch.as_tensor(c).to(device=x.device, dtype=x.dtype)
    return torch.remainder(x * c, _m(base, x))
