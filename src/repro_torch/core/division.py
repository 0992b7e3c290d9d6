"""RNS division and scaling built on the paper's comparison.

Classical restoring division in pure RNS: every magnitude decision is one
Algorithm-1 comparison, and the only extra machinery is doubling (add) and
exact halving (parity via mixed-radix digit sum — all moduli odd ⇒
beta_i ≡ 1 mod 2 ⇒ X mod 2 = sum a_i mod 2).

Operands travel as *packed* tensors (..., n+1) — base residues plus the
redundant m_a channel.  The typed frontend is ``RnsArray.divmod`` /
``.halve`` / ``.scale_pow2`` (core/array.py); the public functions here are
legacy shims over it.  Comparisons, the parity MRC and the halving product
go through the backend resolver: the CUDA kernels on the card.

Wrap discipline: doubling D inside the ring wraps mod M once D·2^j >= M.
The up-phase detects wraps with the comparison itself (2d >= d fails iff
wrap) and the down-phase masks those rungs out.
"""
from __future__ import annotations

import torch

from . import arith
from .base import RNSBase
from .compare import compare_ge_routed
from .dispatch import resolve_backend
from .mrc import mrc_routed

__all__ = ["pack", "unpack", "divmod_rns", "halve", "scale_pow2", "parity"]


def pack(base: RNSBase, x, xa):
    return torch.cat([x, xa[..., None].to(x.dtype)], dim=-1)


def unpack(packed):
    return packed[..., :-1], packed[..., -1]


def padd(base, p, q):
    x = arith.add(base, p[..., :-1], q[..., :-1])
    xa = torch.remainder(p[..., -1] + q[..., -1], base.ma)
    return pack(base, x, xa)


def psub(base, p, q):
    x = arith.sub(base, p[..., :-1], q[..., :-1])
    xa = torch.remainder(p[..., -1] - q[..., -1], base.ma)
    return pack(base, x, xa)


def _packed_ge(base, p, q):
    return compare_ge_routed(
        base, p[..., :-1], p[..., -1], q[..., :-1], q[..., -1], unroll=True
    )


def parity(base: RNSBase, x):
    """X mod 2 from base residues (all moduli odd)."""
    return torch.remainder(mrc_routed(base, x).sum(dim=-1), 2)


def _mul_inv2(base: RNSBase, x):
    """x * 2^{-1} mod m_i on the base channels (the modmul kernel on the
    card)."""
    inv2 = base.tensor("inv2_np", x.device, x.dtype).expand(x.shape)
    if resolve_backend(x, base) == "cuda":
        from ..kernels.ops import modmul_op

        return modmul_op(base, x, inv2)
    return arith.mul(base, x, inv2)


def _halve_impl(base: RNSBase, buf, red_moduli: tuple[int, ...]):
    """Exact floor(X/2) over a channels-last buffer ``(..., n + k)`` whose
    trailing k channels carry the ``red_moduli`` redundant residues
    (k = 0, 1 or 2): subtract the parity bit, multiply by 2^{-1} — per
    channel, each in its own modulus."""
    n = base.n
    x, extra = buf[..., :n], buf[..., n:]
    p = parity(base, x).to(buf.dtype)
    x = arith.sub(base, x, p[..., None].expand(x.shape))
    x = _mul_inv2(base, x)
    cols = [x]
    for i, mr in enumerate(red_moduli):
        xr = torch.remainder(extra[..., i] - p, mr)
        cols.append(torch.remainder(xr * pow(2, -1, mr), mr)[..., None]
                    .to(buf.dtype))
    return torch.cat(cols, dim=-1) if red_moduli else x


def halve(base: RNSBase, packed):
    """Exact floor(X/2) on a packed (..., n+1) tensor.  Legacy shim over
    ``RnsArray.halve``."""
    from .array import RnsArray

    return RnsArray.from_packed(base, packed, device=packed.device).halve().to_packed()


def scale_pow2(base: RNSBase, packed, k: int):
    """floor(X / 2^k) — the paper's 'scaling' application, k exact halvings.
    Legacy shim over ``RnsArray.scale_pow2``."""
    from .array import RnsArray

    return (RnsArray.from_packed(base, packed, device=packed.device)
            .scale_pow2(k).to_packed())


def _divmod_impl(base: RNSBase, xp, dp, *, iters: int | None = None):
    """(Q, R) with X = Q*D + R, 0 <= R < D, entirely in RNS.

    Restoring division.  Up-phase builds the ladder d·2^j (j = 0..nbits) with
    per-rung wrap flags; down-phase walks j = nbits..0, subtracting where the
    Algorithm-1 comparison allows, accumulating Q by Horner (Q = 2Q + bit_j).
    Total comparisons: 2·nbits+1, each one MRC.

    Inputs/outputs are packed (..., n+1).  D must be nonzero.
    """
    nbits = iters if iters is not None else base.M.bit_length()
    valid = torch.ones(xp.shape[:-1], dtype=torch.bool, device=xp.device)
    ladder, valids = [dp], [valid]
    d = dp
    for _ in range(nbits):
        d2 = padd(base, d, d)
        # 2d >= d holds iff no wrap (the wrapped value 2d - M is < d).
        valid = valid & _packed_ge(base, d2, d)
        d = d2
        ladder.append(d)
        valids.append(valid)

    one = torch.ones_like(xp)  # residues of 1 are all 1 (moduli > 1)
    q, r = torch.zeros_like(xp), xp
    for d_j, valid_j in zip(reversed(ladder), reversed(valids)):
        bitx = (_packed_ge(base, r, d_j) & valid_j)[..., None]
        r = torch.where(bitx, psub(base, r, d_j), r)
        # Q = 2Q + bit  (Horner over the quotient bits, in RNS).
        q2 = padd(base, q, q)
        q = torch.where(bitx, padd(base, q2, one), q2)
    return q, r


def divmod_rns(base: RNSBase, xp, dp, *, iters: int | None = None):
    """(Q, R) on packed (..., n+1) operands.  Legacy shim over
    ``RnsArray.divmod``."""
    from .array import RnsArray

    if iters is not None:  # expert knob not exposed on the typed API
        return _divmod_impl(base, xp, dp, iters=iters)
    q, r = RnsArray.from_packed(base, xp, device=xp.device).divmod(
        RnsArray.from_packed(base, dp, device=dp.device)
    )
    return q.to_packed(), r.to_packed()
