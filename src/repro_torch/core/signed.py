"""Signed-value embedding on top of the RNS ring, with sign/magnitude tests
driven by the paper's comparison (Algorithm 1).

A signed v with |v| < M/2 embeds as X = v mod M.  Then:

    v >= 0   <=>   X < ceil(M/2)   <=>   NOT RNSComp_ge(X, ceil(M/2))

so *sign detection costs exactly one comparison*.  Each comparison goes
through ``compare_ge_routed`` — the fused CUDA kernel on the card.

The typed frontend is ``RnsArray.encode_signed`` / ``.is_negative`` /
``.abs_ge`` (core/array.py); the public functions here are legacy shims.
"""
from __future__ import annotations

import torch

from .base import RNSBase
from .compare import compare_ge_routed

__all__ = ["encode_signed", "is_negative", "abs_ge_threshold"]


def _encode_signed_impl(base: RNSBase, v):
    """Signed int tensor -> packed residue tensor (..., n+1), last = m_a."""
    from .convert import tensor_to_rns

    res = tensor_to_rns(base, v)
    # the redundant channel holds (v mod M) mod m_a: m_a does NOT divide M,
    # so negatives are corrected by M mod m_a
    v64 = v.to(torch.int64)
    xa = torch.remainder(v64, base.ma)
    xa = torch.where(v64 < 0, torch.remainder(xa + base.M_mod_ma, base.ma), xa)
    return torch.cat([res, xa[..., None].to(res.dtype)], dim=-1)


def _const_operand(x, xa, residues, ma_residue: int):
    """Broadcast a constant's residues and m_a residue to the operand shapes."""
    cr = torch.as_tensor(residues).to(device=x.device, dtype=x.dtype)
    ca = torch.tensor(ma_residue, dtype=xa.dtype, device=xa.device)
    return cr.expand(x.shape), ca.expand(xa.shape)


def _is_negative_impl(base: RNSBase, packed):
    """True where the packed value encodes v < 0.  One Alg.-1 comparison."""
    x, xa = packed[..., :-1], packed[..., -1]
    t, ta = _const_operand(x, xa, base.tensor("half_M_residues", x.device),
                           base.half_M_ma)
    return compare_ge_routed(base, x, xa, t, ta, unroll=True)  # X >= ceil(M/2)


def _abs_ge_impl(base: RNSBase, packed, thr: int):
    """True where |v| >= thr (0 < thr < M/2).  Two Alg.-1 comparisons:

        v >= 0:  X >= thr
        v <  0:  X <= M - thr   i.e.  NOT (X >= M - thr + 1)
    """
    x, xa = packed[..., :-1], packed[..., -1]

    def cmp_const(c: int):
        cr, ca = _const_operand(x, xa, base.residues_of(c), c % base.ma)
        return compare_ge_routed(base, x, xa, cr, ca, unroll=True)

    neg = _is_negative_impl(base, packed)
    ge_thr = cmp_const(thr)                    # pos case: X >= thr
    ge_mirror = cmp_const(base.M - thr + 1)    # neg case: X > M - thr fails
    return torch.where(neg, ~ge_mirror, ge_thr)


# ------------------------------------------------------------ legacy shims
def encode_signed(base: RNSBase, v):
    """Signed int tensor -> packed residue tensor (..., n+1), last = m_a.
    Legacy shim over ``RnsArray.encode_signed``."""
    from .array import RnsArray

    return RnsArray.encode_signed(base, v, device=v.device).to_packed()


def is_negative(base: RNSBase, packed):
    """True where the packed value encodes v < 0.  Legacy shim over
    ``RnsArray.is_negative``."""
    from .array import RnsArray

    return RnsArray.from_packed(base, packed, signed=True,
                                device=packed.device).is_negative()


def abs_ge_threshold(base: RNSBase, packed, thr: int):
    """True where |v| >= thr (0 < thr < M/2).  Legacy shim over
    ``RnsArray.abs_ge``."""
    from .array import RnsArray

    return RnsArray.from_packed(base, packed, signed=True,
                                device=packed.device).abs_ge(thr)
