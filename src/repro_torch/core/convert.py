"""Conversions: Python ints <-> RNS, MRS -> residue mod m_a (Alg. 3),
and fixed-width integer tensors <-> RNS residue tensors.

``to_ma`` is Algorithm 3 of the paper: given the mixed-radix digits of X,
compute X mod m_a as a dot product against the precomputed partial products
``beta_i = prod_{j<i} m_j mod m_a``.  Cost: n modular mults + (n-1) adds.

Torch has no x64 switch, and an int32 tensor times a Python int wraps
instead of promoting, so every widening below is an explicit int64 cast.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import RNSBase

__all__ = [
    "to_ma",
    "mrs_dot_mod",
    "int_to_rns",
    "rns_to_int",
    "tensor_to_rns",
    "rns_to_tensor",
]


def to_ma(base: RNSBase, digits):
    """Alg. 3: X mod m_a from mixed-radix digits ``(..., n)`` -> ``(...,)``.

    Per-term reduction keeps the accumulator small: each term < m_a <= 2**15,
    so the sum over n <= 2**16 channels stays < 2**31 (int32-safe).
    """
    betas = base.tensor("betas_ma_np", digits.device, digits.dtype)
    terms = torch.remainder(digits * betas, base.ma)
    # torch.sum promotes integer sums to int64; cast back to the lane dtype
    return torch.remainder(terms.sum(dim=-1, dtype=digits.dtype), base.ma)


def mrs_dot_mod(base: RNSBase, digits, targets: tuple[int, ...]):
    """Multi-target Alg. 3: X mod m_t for each target, shape (..., T)."""
    targets = tuple(int(t) for t in targets)
    betas = base.tensor(("betas_for", targets), digits.device, digits.dtype)
    mt = torch.tensor(targets, dtype=digits.dtype, device=digits.device)
    terms = torch.remainder(digits[..., None, :] * betas, mt[:, None])
    return torch.remainder(terms.sum(dim=-1, dtype=digits.dtype), mt)


# --------------------------------------------------------------------------
# Exact host-side conversions (tests, oracles)
# --------------------------------------------------------------------------


def int_to_rns(base: RNSBase, x: int) -> np.ndarray:
    """Residues of a Python int (negative x embeds as x mod M)."""
    return base.residues_of(x)


def rns_to_int(base: RNSBase, residues) -> int:
    """Exact value in [0, M) via CRT on Python ints (host-side oracle)."""
    if isinstance(residues, torch.Tensor):
        residues = residues.cpu().numpy()
    x = 0
    for r, m in zip(np.asarray(residues).tolist(), base.moduli):
        Mi = base.M // m
        x = (x + (int(r) * pow(Mi, -1, m) % m) * Mi) % base.M
    return x


# --------------------------------------------------------------------------
# Tensor codecs
# --------------------------------------------------------------------------


def tensor_to_rns(base: RNSBase, x):
    """Integer tensor -> residue tensor ``(..., n)`` in the lane dtype.

    Works for signed x: ``torch.remainder`` returns non-negative remainders,
    and (x mod m_i) == ((x mod M) mod m_i).  |x| must be < M/2 for the
    signed embedding to round-trip.
    """
    m = base.tensor("moduli_np", x.device, torch.int64)
    return torch.remainder(x[..., None].to(torch.int64), m).to(base.tdtype)


def rns_to_tensor(base: RNSBase, digits_or_residues, *, from_digits=False):
    """Residue tensor -> int64 values in [0, M) via MRC + Horner.

    Requires M < 2**62.  Pass mixed-radix digits with ``from_digits=True``
    to skip the MRC, which otherwise goes through the backend resolver.
    """
    from .mrc import mrc_routed

    if base.M >= 1 << 62:
        raise ValueError("rns_to_tensor requires M < 2**62; use rns_to_int")
    d = digits_or_residues if from_digits else mrc_routed(base, digits_or_residues)
    d = d.to(torch.int64)
    acc = d[..., base.n - 1]
    for i in range(base.n - 2, -1, -1):
        acc = acc * int(base.moduli[i]) + d[..., i]
    return acc
