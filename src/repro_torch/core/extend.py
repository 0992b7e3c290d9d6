"""Base extension: convert residues in base B to residues in a target base.

* ``extend_mrc``      — exact, via MRC + multi-target Alg. 3 dot (the MRC
  goes through the backend resolver).
* ``extend_shenoy``   — exact CRT-form extension using a redundant residue
  (Shenoy–Kumaresan); requires x_r == X mod m_r to be TRUE.
* ``extend_kawamura`` — approximate CRT (Cox–Rower); k can be off by one
  near the top of the range.
"""
from __future__ import annotations

import torch

from .base import RNSBase
from .convert import mrs_dot_mod
from .mrc import mrc_routed

__all__ = ["extend_mrc", "extend_shenoy", "extend_kawamura"]


def _extend_mrc_impl(base: RNSBase, x, targets: tuple[int, ...]):
    """MRC + multi-target Alg.-3 dot — the route of ``RnsArray.extend``."""
    return mrs_dot_mod(base, mrc_routed(base, x), targets)


def extend_mrc(base: RNSBase, x, targets: tuple[int, ...]):
    """Exact extension of ``x: (..., n)`` to residues mod each target, (..., T).

    Legacy shim over ``RnsArray.extend``.

    >>> import torch
    >>> from repro_torch.core.base import RNSBase
    >>> from repro_torch.core.extend import extend_mrc
    >>> base = RNSBase(moduli=(3, 5, 7), ma=11, bits=15)
    >>> x = torch.tensor([[52 % 3, 52 % 5, 52 % 7]], dtype=torch.int32)
    >>> extend_mrc(base, x, (11, 13)).tolist()       # 52 mod 11, 52 mod 13
    [[8, 0]]
    """
    from .array import RnsArray

    return RnsArray.from_parts(base, x, device=x.device).extend(tuple(targets))


def _xi(base: RNSBase, x):
    """CRT coefficients xi_i = |x_i * Mi^{-1}|_{m_i}, in int64."""
    mi_inv = base.tensor("Mi_inv_np", x.device, x.dtype)
    m = base.tensor("moduli_np", x.device, x.dtype)
    return torch.remainder(x * mi_inv, m).to(torch.int64)


def _sum_mi_mod_t(base: RNSBase, xi, targets):
    """(..., T): sum_i (xi_i * (M_i mod m_t) mod m_t), plus the T-vectors
    M mod m_t and m_t (all int64)."""
    dev = xi.device
    targets = tuple(int(t) for t in targets)
    mi_mod_t = base.tensor(("Mi_mod", targets), dev, torch.int64)  # (T, n)
    m_mod_t = base.tensor(("M_mod", targets), dev, torch.int64)    # (T,)
    mt = torch.tensor(targets, dtype=torch.int64, device=dev)
    s = torch.remainder(xi[..., None, :] * mi_mod_t, mt[:, None]).sum(dim=-1)
    return s, m_mod_t, mt


def extend_shenoy(base: RNSBase, x, xr, mr: int, targets: tuple[int, ...]):
    """Shenoy–Kumaresan: exact, given the redundant residue xr = X mod m_r.

    Y = sum xi_i M_i = X + k M with 0 <= k < n, so k is recovered mod m_r
    (requires m_r > n) and subtracted off in each target channel.

    >>> import torch
    >>> from repro_torch.core.base import RNSBase
    >>> from repro_torch.core.extend import extend_shenoy
    >>> base = RNSBase(moduli=(3, 5, 7), ma=11, bits=15)
    >>> x = torch.tensor([[52 % 3, 52 % 5, 52 % 7]], dtype=torch.int32)
    >>> xr = torch.tensor([52 % 11])                 # TRUE redundant residue
    >>> extend_shenoy(base, x, xr, 11, (13,)).tolist()
    [[0]]
    """
    if mr <= base.n:
        raise ValueError("Shenoy extension needs m_r > n")
    xi = _xi(base, x)  # (..., n)
    mi_mod_r = base.tensor(("Mi_mod", (mr,)), x.device, torch.int64)[0]  # (n,)
    y_mod_r = torch.remainder(torch.remainder(xi * mi_mod_r, mr).sum(dim=-1), mr)
    m_inv_r = pow(base.M % mr, -1, mr)
    k = torch.remainder((y_mod_r - xr.to(torch.int64)) * m_inv_r, mr)  # exact k < n
    s, m_mod_t, mt = _sum_mi_mod_t(base, xi, targets)
    return torch.remainder(s - k[..., None] * m_mod_t, mt).to(x.dtype)


def extend_kawamura(
    base: RNSBase, x, targets: tuple[int, ...], *, alpha: float = 0.5, q: int = 8
):
    """Kawamura et al. (Cox–Rower) approximate extension.

    k ~= floor(sum_i xi_i / m_i + alpha) approximated with the top q bits of
    xi_i (moduli are ~2^bits so xi/m ~ xi >> (bits - q)).  Exact except near
    the ends of the range.
    """
    xi = _xi(base, x)
    trunc = xi >> (base.bits - q)
    k = (trunc.sum(dim=-1) + int(alpha * (1 << q))) >> q  # (...,)
    s, m_mod_t, mt = _sum_mi_mod_t(base, xi, targets)
    return torch.remainder(s - k[..., None] * m_mod_t, mt).to(x.dtype)
