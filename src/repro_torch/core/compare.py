"""RNS comparison — the paper's contribution (Algorithm 1) plus baselines.

``rns_compare_ge`` implements Algorithm 1 / Theorem 1:

    Delta' = (n_a^(1) - n_a^(2)) mod m_a
    z      = (N1 - N2) channel-wise in B            (= (N1-N2) mod M)
    Delta  = to_ma(MRC(z))                          (= ((N1-N2) mod M) mod m_a)
    N1 >= N2  <=>  Delta == Delta'

One MRC + one Alg.3 dot = (n(n-1)/2 + n) modular mults — half the classical
method's n(n-1).  Valid on the FULL range 0 <= N1,N2 < M.

Baselines: ``classic_compare_ge`` (two MRCs + lexicographic digit compare)
and ``approx_crt_ge`` (fractional-CRT positions; wrong for close operands).
"""
from __future__ import annotations

import torch

from . import arith
from .base import RNSBase
from .convert import to_ma
from .dispatch import resolve_backend
from .mrc import mrc, mrc_routed, mrc_unrolled, mrs_ge

__all__ = ["rns_compare_ge", "classic_compare_ge", "approx_crt_ge",
           "compare_packed_ge"]


def _compare_ge_impl(base: RNSBase, x1, xa1, x2, xa2, *, unroll: bool = False):
    """Algorithm 1 in plain torch."""
    delta_p = torch.remainder(xa1 - xa2, base.ma)        # line 1
    z = arith.sub(base, x1, x2)                          # line 2
    digits = (mrc_unrolled if unroll else mrc)(base, z)  # line 3 (Alg. 2)
    delta = to_ma(base, digits)                          # line 4 (Alg. 3)
    return delta == delta_p                              # lines 5-9 (Thm. 1)


def compare_ge_routed(base: RNSBase, x1, xa1, x2, xa2, *, unroll: bool = False):
    """Algorithm 1 through the backend resolver: the fused CUDA kernel, or
    ``_compare_ge_impl``.  Every Alg.-1 call of the port goes through here."""
    if resolve_backend(x1, base) == "cuda":
        from ..kernels.ops import compare_op

        return compare_op(base, x1, xa1, x2, xa2)
    return _compare_ge_impl(base, x1, xa1, x2, xa2, unroll=unroll)


def rns_compare_ge(base: RNSBase, x1, xa1, x2, xa2, *, unroll: bool = False):
    """Algorithm 1.  All args batched: x*: (..., n), xa*: (...,).

    Returns a boolean tensor: True where N1 >= N2.  Legacy shim over
    ``RnsArray.compare_ge``.
    """
    from .array import RnsArray

    a = RnsArray.from_parts(base, x1, xa1, device=x1.device)
    b = RnsArray.from_parts(base, x2, xa2, device=x2.device)
    return a.compare_ge(b, unroll=unroll)


def compare_packed_ge(base: RNSBase, p1, p2, *, unroll: bool = True):
    """Alg. 1 on 'packed' tensors (..., n+1) whose last channel is the
    redundant residue.  Legacy shim over ``RnsArray.compare_ge``."""
    from .array import RnsArray

    a = RnsArray.from_packed(base, p1[..., : base.n + 1], device=p1.device)
    b = RnsArray.from_packed(base, p2[..., : base.n + 1], device=p2.device)
    return a.compare_ge(b, unroll=unroll)


def classic_compare_ge(base: RNSBase, x1, x2, *, unroll: bool = False):
    """Classical method: MRC both operands, compare digits lexicographically.

    Cost: n(n-1) modular mults + n digit compares (paper Table 1, row 2).
    Both MRCs go through the backend resolver; ``unroll`` picks the plain
    variant, which gives the same digits.
    """
    if resolve_backend(x1, base) == "cuda":
        return mrs_ge(mrc_routed(base, x1), mrc_routed(base, x2))
    f = mrc_unrolled if unroll else mrc
    return mrs_ge(f(base, x1), f(base, x2))


def approx_crt_ge(base: RNSBase, x1, x2, *, frac_bits: int = 30):
    """Approximate-CRT comparison baseline (Kawamura-style fractions).

    Position of X in [0,1):  pos(X) ~= sum_i |x_i * Mi^{-1}|_{m_i} / m_i mod 1,
    compared in fixed point.  Exact only when |N1 - N2| / M exceeds the
    accumulated rounding error.
    """
    mi_inv = base.tensor("Mi_inv_np", x1.device, x1.dtype)
    m = base.tensor("moduli_np", x1.device, x1.dtype)
    m64 = base.tensor("moduli_np", x1.device, torch.int64)

    def pos(x):
        xi = torch.remainder(x * mi_inv, m).to(torch.int64)  # |x_i Mi^{-1}|_{m_i}
        fr = (xi << frac_bits) // m64                     # fixed-point xi / m_i
        return torch.remainder(fr.sum(dim=-1), 1 << frac_bits)

    return pos(x1) >= pos(x2)
