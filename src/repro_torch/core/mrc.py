"""Mixed-Radix Conversion (Alg. 2 of the paper) and MRS utilities.

``mrc`` computes the mixed-radix digits a_1..a_n of X from its residues:

    X = a_1 + a_2 m_1 + a_3 m_1 m_2 + ... + a_n m_1...m_{n-1}     (eq. 2)

The triangular recurrence is sequential in j but parallel in the channel
index i and across batch elements: the j-loop is a Python loop (depth n-1)
over whole-tensor ops.  Work: n(n-1)/2 modular multiplications.

``mrc_routed`` is the entry the rest of the port calls: it sends CUDA tensors
on int32-lane bases to the hand-written kernel (kernels/ops.py) through the
one resolver in dispatch.py, and everything else to ``mrc``.
"""
from __future__ import annotations

import torch

from .base import RNSBase
from .dispatch import resolve_backend

__all__ = ["mrc", "mrc_routed", "mrs_ge", "mrs_to_int", "mrc_unrolled"]


def mrc(base: RNSBase, x):
    """Mixed-radix digits of a batched residue tensor ``x: (..., n)``.

    Returns digits ``(..., n)`` with 0 <= a_i < m_i, channels last.

    >>> import torch
    >>> from repro_torch.core.base import RNSBase
    >>> from repro_torch.core.mrc import mrc, mrs_to_int
    >>> base = RNSBase(moduli=(3, 5, 7), ma=11, bits=15)
    >>> x = torch.tensor([[52 % 3, 52 % 5, 52 % 7]])  # residues of X = 52
    >>> digits = mrc(base, x)
    >>> digits.tolist()                              # 52 = 1 + 2*3 + 3*15
    [[1, 2, 3]]
    >>> mrs_to_int(base, digits[0])
    52
    """
    m = base.tensor("moduli_np", x.device, x.dtype)
    inv = base.tensor("inv_tri_np", x.device, x.dtype)  # inv[j, i] = m_j^{-1} mod m_i
    idx = torch.arange(base.n, device=x.device)
    w = x
    for j in range(base.n - 1):
        d = w - w[..., j : j + 1]
        d = torch.where(d < 0, d + m, d)          # (w - a_j) mod m_i
        upd = torch.remainder(d * inv[j], m)      # < 2**30 in int32 lanes
        w = torch.where(idx > j, upd, w)          # freeze digits a_1..a_j
    return w


def mrc_unrolled(base: RNSBase, x):
    """Column-stacking variant (identical math), as in the reference.

    >>> import torch
    >>> from repro_torch.core.base import RNSBase
    >>> from repro_torch.core.mrc import mrc, mrc_unrolled
    >>> base = RNSBase(moduli=(3, 5, 7), ma=11, bits=15)
    >>> x = torch.tensor([[1, 2, 3], [0, 4, 6]])
    >>> bool((mrc_unrolled(base, x) == mrc(base, x)).all())
    True
    """
    m = base.tensor("moduli_np", x.device, x.dtype)
    inv = base.tensor("inv_tri_np", x.device, x.dtype)
    w = x
    cols = [w[..., 0]]
    for j in range(base.n - 1):
        d = w - cols[j][..., None]
        d = torch.where(d < 0, d + m, d)
        w = torch.remainder(d * inv[j], m)
        cols.append(w[..., j + 1])
    return torch.stack(cols, dim=-1)


def mrc_routed(base: RNSBase, x):
    """Alg. 2 through the backend resolver: the CUDA kernel or ``mrc``."""
    if resolve_backend(x, base) == "cuda":
        from ..kernels.ops import mrc_op

        return mrc_op(base, x)
    return mrc(base, x)


def mrs_ge(d1, d2):
    """Lexicographic >= on mixed-radix digit tensors ``(..., n)``.

    MRS is positional with a_n most significant, so compare at the most
    significant differing digit.

    >>> import torch
    >>> from repro_torch.core.mrc import mrs_ge
    >>> d52 = torch.tensor([1, 2, 3])   # digits of 52 in base (3, 5, 7)
    >>> d51 = torch.tensor([0, 2, 3])   # digits of 51
    >>> bool(mrs_ge(d52, d51)), bool(mrs_ge(d51, d52))
    (True, False)
    """
    neq = d1 != d2
    n = d1.shape[-1]
    # argmax has no Bool kernel: cast first.  The first maximum over the
    # reversed mask is the most significant differing position.
    rev_first = torch.argmax(neq.flip(-1).to(torch.int32), dim=-1)
    pos = (n - 1 - rev_first)[..., None]
    a = torch.take_along_dim(d1, pos, dim=-1)[..., 0]
    b = torch.take_along_dim(d2, pos, dim=-1)[..., 0]
    return torch.where(neq.any(dim=-1), a > b, True)


def mrs_to_int(base: RNSBase, digits) -> int:
    """Exact Python-int value of a single digit vector (tests/debug only)."""
    acc, w = 0, 1
    for a, m in zip((int(v) for v in digits), base.moduli):
        acc += a * w
        w *= m
    return acc
