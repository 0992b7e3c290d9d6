"""Dual-base Montgomery product and fused ladder bit: the CUDA kernels
``csrc/mont_ladder.cu`` and their plain torch versions.

Counterparts of ``src/repro/kernels/mont_ladder.py::mont_mul_kernel_call``
and ``::mont_ladder_kernel_call``.  One Montgomery product MM(X, Y) on a
column chains every RNS primitive of the package (core/montgomery.py
documents the algebra):

    q      = x·y·(-N^{-1})    channel-wise in B       Barrett products
    digits = MRC(q)           Alg. 2 triangle          (mrc_rows)
    q'     = digits · betas   Alg. 3 dot -> B'         (_dot_rows)
    r'     = (x'y' + q'N)·M^{-1}  channel-wise in B'
    r      = extend(r')       MRC + dot back to B (+ redundant channels)

The ladder kernel fuses ONE exponent bit — two products and the branchless
select.  Per-request moduli ``N`` arrive as data (``neg``/``nhi`` per
column), so one launch serves a batch of different moduli.

Operands are channel-major int32: ``lo`` (nch_lo, B), ``hi`` (n_hi, B),
``neg`` (n, B), ``nhi`` (n_hi, B), ``bit`` (B,).  The seven tables, in the
kernel's orientation (``ops._mont_tables`` builds them):

    inv_lo (n, n)        inv_lo[j, i] = m_j^{-1} mod m_i
    m_lo (nch_lo,)       B-side channel moduli, base then redundant
    bl2h (n, n_hi)       bl2h[j, t] = prod_{k<j} m_k mod m'_t
    inv_hi (n_hi, n_hi)  the same triangle over B'
    m_hi (n_hi,)         B' moduli
    bh2l (n_hi, nch_lo)  bh2l[j, t] = prod_{k<j} m'_k mod m_t
    minv (n_hi,)         M^{-1} mod m'_j

Inputs < 2N per column keep every output < 2N, every intermediate product
inside the exact Barrett range, and both extensions exact.
"""
from __future__ import annotations

import torch

from . import build
from .common import barrett_mod, mrc_rows, recip

__all__ = ["mont_mul_kernel_call", "mont_ladder_kernel_call",
           "mont_mul_plain", "mont_ladder_plain", "MAX_CHANNELS"]

# Channels a side the kernels take: 32 lanes times the register slots of
# their widest template instance (csrc/mont_ladder.cu, kMaxSlots).
MAX_CHANNELS = 160


def _dot_rows(digits, betas, m):
    """Alg. 3 dot against T targets on an (n, B) digit tile -> (T, B).

    betas: (n, T) with betas[j, t] = prod_{k<j} m_k mod m_t;  m: (T,).
    Each term is Barrett-reduced and the running sum kept < m by one
    conditional subtract, as the kernel and the reference's ``_dot_rows``
    do.
    """
    m_col = m[:, None]
    r_col = recip(m_col)
    acc = torch.zeros((m.shape[0], digits.shape[1]), dtype=torch.int32,
                      device=digits.device)
    for j in range(digits.shape[0]):
        s = acc + barrett_mod(digits[j] * betas[j][:, None], m_col, r_col)
        acc = torch.where(s >= m_col, s - m_col, s)
    return acc


def _mm_tile(xlo, xhi, ylo, yhi, neg, nhi, inv_lo, m_lo, bl2h, inv_hi,
             m_hi, bh2l, minv):
    """One Montgomery product on (rows, B) tiles; returns (lo, hi)."""
    n = inv_lo.shape[0]
    mlo, mhi = m_lo[:, None], m_hi[:, None]
    rlo, rhi = recip(mlo), recip(mhi)
    mb, rb = mlo[:n], rlo[:n]
    q = barrett_mod(barrett_mod(xlo[:n] * ylo[:n], mb, rb) * neg, mb, rb)
    qp = _dot_rows(mrc_rows(q, inv_lo, m_lo[:n]), bl2h, m_hi)     # (n_hi, B)
    t = barrett_mod(xhi * yhi, mhi, rhi) + barrett_mod(qp * nhi, mhi, rhi)
    t = torch.where(t >= mhi, t - mhi, t)
    r_hi = barrett_mod(t * minv[:, None], mhi, rhi)
    r_lo = _dot_rows(mrc_rows(r_hi, inv_hi, m_hi), bh2l, m_lo)    # (nch_lo, B)
    return r_lo, r_hi


def mont_mul_plain(xlo, xhi, ylo, yhi, neg, nhi, *tables):
    """The product kernel's function in plain torch (any device)."""
    return _mm_tile(xlo, xhi, ylo, yhi, neg, nhi, *tables)


def mont_ladder_plain(r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, *tables):
    """The ladder kernel's function in plain torch (any device): both
    products always run and the select is a data-independent ``where``."""
    keep = (bit == 0)[None, :]
    t_lo, t_hi = _mm_tile(r0lo, r0hi, r1lo, r1hi, neg, nhi, *tables)
    sq_lo = torch.where(keep, r0lo, r1lo)
    sq_hi = torch.where(keep, r0hi, r1hi)
    s_lo, s_hi = _mm_tile(sq_lo, sq_hi, sq_lo, sq_hi, neg, nhi, *tables)
    return (torch.where(keep, s_lo, t_lo), torch.where(keep, s_hi, t_hi),
            torch.where(keep, t_lo, s_lo), torch.where(keep, t_hi, s_hi))


def _shapes(what, lo, hi, neg, nhi, tables):
    """(n, nch_lo, n_hi, B) after checking every operand and table shape."""
    nch_lo, B = lo.shape
    n_hi, n = hi.shape[0], neg.shape[0]
    want = [(n, n), (nch_lo,), (n, n_hi), (n_hi, n_hi), (n_hi,),
            (n_hi, nch_lo), (n_hi,)]
    got = [tuple(t.shape) for t in tables]
    if (hi.shape != (n_hi, B) or neg.shape != (n, B) or nhi.shape != (n_hi, B)
            or got != want or n > nch_lo):
        raise ValueError(f"{what}: operand or table shapes do not fit "
                         f"(n={n}, nch_lo={nch_lo}, n_hi={n_hi}, B={B}; "
                         f"tables {got})")
    if max(nch_lo, n_hi) > MAX_CHANNELS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_CHANNELS} "
                         f"channels a side, got nch_lo={nch_lo}, n_hi={n_hi}")
    return n, nch_lo, n_hi, B


def mont_mul_kernel_call(xlo, xhi, ylo, yhi, neg, nhi, *tables):
    """Launch ``rns_mont_mul`` on PyTorch's current stream (no sync);
    returns ``(olo (nch_lo, B), ohi (n_hi, B))``."""
    n, nch_lo, n_hi, B = _shapes("mont_mul", xlo, xhi, neg, nhi, tables)
    if ylo.shape != xlo.shape or yhi.shape != xhi.shape:
        raise ValueError("mont_mul: x and y tiles differ in shape")
    olo, ohi = torch.empty_like(xlo), torch.empty_like(xhi)
    ptrs = build.pointers("mont_mul", xlo, xhi, ylo, yhi, neg, nhi, olo, ohi,
                          *tables)
    with torch.cuda.device(xlo.device):
        err = build.load().rns_mont_mul(*ptrs, n, nch_lo, n_hi, B,
                                        build.stream(xlo.device))
    build.check(err, "mont_mul")
    return olo, ohi


def mont_ladder_kernel_call(r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, *tables):
    """Launch ``rns_mont_ladder`` on PyTorch's current stream (no sync);
    ``bit: (B,)`` int32.  Returns ``(o0lo, o0hi, o1lo, o1hi)``."""
    n, nch_lo, n_hi, B = _shapes("mont_ladder", r0lo, r0hi, neg, nhi, tables)
    if (r1lo.shape != r0lo.shape or r1hi.shape != r0hi.shape
            or bit.shape != (B,)):
        raise ValueError("mont_ladder: r0, r1 and bit shapes do not fit")
    outs = [torch.empty_like(t) for t in (r0lo, r0hi, r0lo, r0hi)]
    ptrs = build.pointers("mont_ladder", r0lo, r0hi, r1lo, r1hi, bit, neg,
                          nhi, *outs, *tables)
    with torch.cuda.device(r0lo.device):
        err = build.load().rns_mont_ladder(*ptrs, n, nch_lo, n_hi, B,
                                           build.stream(r0lo.device))
    build.check(err, "mont_ladder")
    return tuple(outs)
