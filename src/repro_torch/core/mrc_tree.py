"""Divide-and-conquer Mixed-Radix Conversion — the paper's parallel claim.

A recursive split of the base

    X = A + M1 · B,   A = X mod M1 (MRS digits on B1, recursively),
                      B = floor(X / M1) with residues on B2:
                          b_j = (x_j − A mod m_j) · M1^{-1} mod m_j,

where ``A mod m_j`` is a base extension of A's digits into B2 — a dot
product against precomputed partial products (Alg. 3 generalized).  Total:
O(log² n) depth, O(n²) work — the same digits as Alg. 2.

Plain torch only, in int64; the recursion is unrolled in Python.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .base import RNSBase

__all__ = ["mrc_tree"]


@functools.lru_cache(maxsize=None)
def _tree_tables(moduli: tuple):
    """Per tree node: the split point, betas of B1 into B2, M1^{-1} mod B2
    and B2 itself (numpy int64)."""
    half = len(moduli) // 2
    b1, b2 = moduli[:half], moduli[half:]
    M1 = 1
    for m in b1:
        M1 *= m
    betas = np.zeros((len(b2), len(b1)), dtype=np.int64)
    for t, mt in enumerate(b2):
        acc = 1
        for i, mi in enumerate(b1):
            betas[t, i] = acc % mt
            acc = (acc * mi) % mt
    m1_inv = np.asarray([pow(M1 % mt, -1, mt) for mt in b2], dtype=np.int64)
    return half, betas, m1_inv, np.asarray(b2, dtype=np.int64)


def _mrc_rec(moduli: tuple, x):
    """x: (..., n) int64 residues on `moduli` -> (..., n) MRS digits."""
    if len(moduli) == 1:
        return x
    half, betas_np, m1_inv_np, m2_np = _tree_tables(moduli)
    betas, m1_inv, m2 = (torch.from_numpy(a).to(x.device)
                         for a in (betas_np, m1_inv_np, m2_np))
    a_digits = _mrc_rec(moduli[:half], x[..., :half])
    # extend A into B2: A mod m_t = sum_i a_i * beta[t, i]
    terms = torch.remainder(a_digits[..., None, :] * betas, m2[:, None])
    a_mod = torch.remainder(terms.sum(dim=-1), m2)
    b_res = torch.remainder((x[..., half:] - a_mod) * m1_inv, m2)
    b_digits = _mrc_rec(moduli[half:], b_res)
    return torch.cat([a_digits, b_digits], dim=-1)


def mrc_tree(base: RNSBase, x):
    """Log²-depth MRC; digits identical to ``core.mrc.mrc``."""
    digits = _mrc_rec(tuple(int(m) for m in base.moduli), x.to(torch.int64))
    return digits.to(x.dtype)
