"""Dual-base RNS Montgomery arithmetic over the typed ``RnsArray`` frontend.

This is the paper's motivating context (§1, §3): cryptographic modular
multiplication keeps every operand in TWO RNS bases B and B'.  The redundant
modulus m_a rides along as an extra ``RnsArray`` channel of the B-side value
(``Layout.BASE_MA``, or ``Layout.RRNS`` with a second redundant channel for
locate-and-correct wire codewords), which is why "the redundant residue is
readily available" and the final comparison costs only ONE conversion.

One Montgomery product MM(X, Y) = X·Y·M^{-1} mod N (operands in both bases):

    q   <- x·y·(-N^{-1})  in B             (q < M)
    q'  <- extend(q)      B  -> B'          (exact MRC extension, Alg. 2+3)
    t'  <- x'·y' + q'·N   in B'             (t = XY + qN ≡ 0 mod M)
    r'  <- t'·M^{-1}      in B'             (exact division by M)
    r   <- extend(r')     B' -> B           (plus the redundant channels)
    result r ≡ X·Y·M^{-1} (mod N),  r < 2N  (needs M > 4N, M' > 2N)

The B-side extension targets include the redundant channels, and those stay
EXACT through every product: r'_j·(M^{-1} mod m'_j) ≡ R mod m'_j holds
per-channel because R·M = T over the integers, so the extension's MRC digits
represent the true R < M' and any extra target channel (m_a, m_b) receives
the true residue of R.  The B'-side value needs no redundant channels (the
comparison and the wire codewords live on the B side), so ``DualRep.hi`` is
always ``Layout.BASE``.

Backend dispatch happens HERE (like ``RnsArray``'s methods): for a CUDA
tensor on 15-bit bases, ``mont_mul``/``ladder_step`` route through
``core.dispatch.resolve_backend`` to the CUDA kernels of
``repro_torch.kernels.mont_ladder``; otherwise the plain torch product below
runs.  Both are exact modular integer arithmetic, hence bitwise-identical.

>>> from repro_torch.core import RNSBase, gen_coprime_moduli
>>> from repro_torch.core.montgomery import RNSMontgomery
>>> ms = gen_coprime_moduli(14, 15)
>>> B = RNSBase(moduli=tuple(ms[:6]), ma=ms[12], bits=15)
>>> Bp = RNSBase(moduli=tuple(ms[6:12]), ma=ms[13], bits=15)
>>> mont = RNSMontgomery(B, Bp, N=10**20 + 39, device="cpu")  # ~67 bits
>>> mont.modmul(10**19 + 7, 10**18 + 9) == (10**19 + 7) * (10**18 + 9) % mont.N
True
>>> mont.modexp(123456789, 65537) == pow(123456789, 65537, mont.N)
True
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import arith
from .array import Layout, RnsArray, _device
from .base import RNSBase
from .convert import mrs_dot_mod, rns_to_int
from .dispatch import resolve_backend
from .extend import extend_kawamura, extend_mrc
from .mrc import mrc

__all__ = ["DualRep", "RNSMontgomery", "mont_mul", "ladder_step",
           "ladder_steps", "mont_consts", "minv_residues", "exp_bits_msb"]


@dataclasses.dataclass(frozen=True)
class DualRep:
    """One big-integer value held in both Montgomery bases.

    ``lo`` is the B-side ``RnsArray`` (any layout — its redundant channels
    are maintained exactly through ``mont_mul``); ``hi`` is the B'-side
    value, always ``Layout.BASE``.  The legacy raw-tensor attributes ``xB``
    and ``xBp`` are kept as views for pre-RnsArray callers.
    """

    lo: RnsArray
    hi: RnsArray

    def __post_init__(self):
        if self.hi.layout is not Layout.BASE:
            raise ValueError("DualRep.hi carries no redundant channels "
                             "(Layout.BASE); the comparison lives on .lo")

    @property
    def xB(self):
        """Legacy view: B-side base residue channels ``(..., n)``."""
        return self.lo.x

    @property
    def xBp(self):
        """Legacy view: B'-side residue channels ``(..., n')``."""
        return self.hi.x


# ------------------------------------------------------------- constants


def _channel_targets(base: RNSBase, layout: Layout,
                     mb: int | None) -> tuple[int, ...]:
    """Channel moduli of an RnsArray over ``base`` with ``layout``."""
    reds = ((), (base.ma,), (base.ma, mb))[layout.n_redundant]
    if layout is Layout.RRNS and mb is None:
        raise ValueError("RRNS layout needs the second redundant modulus mb=")
    return tuple(int(m) for m in base.moduli) + tuple(int(m) for m in reds)


@functools.lru_cache(maxsize=None)
def minv_residues(baseB: RNSBase, hi_targets: tuple[int, ...]) -> np.ndarray:
    """``M^{-1} mod m'_j`` per B'-side channel — N-independent, cached."""
    try:
        return np.asarray([pow(baseB.M % t, -1, t) for t in hi_targets],
                          dtype=baseB.dtype)
    except ValueError as e:
        raise ValueError(
            f"every B'-side channel modulus must be coprime to M: {e}"
        ) from None


def mont_consts(baseB: RNSBase, baseBp: RNSBase, N: int, *,
                layout: Layout = Layout.BASE_MA,
                mb: int | None = None) -> dict[str, np.ndarray]:
    """Host-computed per-``N`` channel constants (exact big-int residues).

    Keys: ``neg`` = -N^{-1} mod m_i over B's base channels (n,); ``n_lo`` /
    ``m2_lo`` / ``one_lo`` = residues of N, M² mod N, M mod N over ALL
    B-side channels of ``layout``; ``n_hi`` / ``m2_hi`` / ``one_hi`` = the
    same over B'-side base channels.  All are broadcast-ready rows for
    batched ``mont_mul`` — the serve engine stacks one row per slot.
    """
    if not (baseB.M > 4 * N and baseBp.M > 2 * N):
        raise ValueError("need M > 4N and M' > 2N for bounded outputs")
    if math.gcd(baseB.M, baseBp.M) != 1:
        raise ValueError("bases must be coprime")
    if math.gcd(N, baseB.M) != 1:
        raise ValueError("N must be coprime to M (it has N^{-1} mod m_i)")
    lo_t = _channel_targets(baseB, layout, mb)
    hi_t = tuple(int(m) for m in baseBp.moduli)
    m2 = (baseB.M * baseB.M) % N
    one = baseB.M % N
    enc = lambda v, ts: np.asarray([v % t for t in ts], dtype=baseB.dtype)
    return {
        "neg": np.asarray([(-pow(N, -1, m)) % m for m in baseB.moduli],
                          dtype=baseB.dtype),
        "n_lo": enc(N, lo_t), "n_hi": enc(N, hi_t),
        "m2_lo": enc(m2, lo_t), "m2_hi": enc(m2, hi_t),
        "one_lo": enc(one, lo_t), "one_hi": enc(one, hi_t),
    }


def exp_bits_msb(e: int, nbits: int) -> np.ndarray:
    """``(nbits,)`` int32 exponent bits, most-significant first.  Leading
    zeros are ladder no-ops (r0 stays 1̄), so a fixed-width ladder computes
    any exponent of ≤ ``nbits`` bits in constant time."""
    if e < 0 or e.bit_length() > nbits:
        raise ValueError(f"exponent needs {e.bit_length()} bits > {nbits}")
    return np.asarray([(e >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                      dtype=np.int32)


# ------------------------------------------------------- the multiplication


def _row(v, like):
    """A per-``N`` constant row (numpy or tensor) on ``like``'s device, in
    its dtype."""
    return torch.as_tensor(v).to(device=like.device, dtype=like.dtype)


def _mont_mul_torch(x: DualRep, y: DualRep, neg, n_hi) -> DualRep:
    """Plain torch MM — calls the impl functions directly (the plain MRC,
    not the routed one), so this path stays plain even on the card."""
    bB, bBp = x.lo.base, x.hi.base
    lo_t = _channel_targets(bB, x.lo.layout, x.lo.mb)
    hi_t = tuple(int(m) for m in bBp.moduli)
    xl, xh = x.lo.x, x.hi.x
    mh = bBp.tensor("moduli_np", xh.device, xh.dtype)
    # q = x·y·(-N^{-1}) over B's base channels
    q = arith.mul(bB, arith.mul(bB, xl, y.lo.x), _row(neg, xl))
    qp = mrs_dot_mod(bB, mrc(bB, q), hi_t)                  # exact B -> B'
    t = arith.add(bBp, arith.mul(bBp, xh, y.hi.x),
                  torch.remainder(qp * _row(n_hi, qp), mh))
    minv = torch.from_numpy(minv_residues(bB, hi_t)).to(t.device, t.dtype)
    rp = torch.remainder(t * minv, mh)
    r = mrs_dot_mod(bBp, mrc(bBp, rp), lo_t)                # exact B' -> B(+reds)
    return DualRep(x.lo._wrap(r.to(x.lo.dtype), signed=False),
                   x.hi._wrap(rp.to(x.hi.dtype), signed=False))


def _check_pair(x: DualRep, y: DualRep):
    if (x.lo.base is not y.lo.base and x.lo.base != y.lo.base) or \
            x.lo.layout is not y.lo.layout or x.lo.mb != y.lo.mb:
        raise ValueError("mont_mul operands need matching bases and layout")


def _on_kernels(d: DualRep) -> bool:
    """The route of a Montgomery op on ``d``: the CUDA kernels when BOTH
    bases resolve to them (a CUDA tensor, 15-bit moduli)."""
    return (resolve_backend(d.lo.residues, d.lo.base) == "cuda"
            and resolve_backend(d.hi.residues, d.hi.base) == "cuda")


def mont_mul(x: DualRep, y: DualRep, neg, n_hi) -> DualRep:
    """Batched Montgomery product MM(X, Y) = X·Y·M^{-1} mod N, result < 2N
    when inputs are < 2N.  ``neg``/``n_hi`` are per-``N`` channel rows from
    ``mont_consts`` (broadcastable against the batch, so one call can mix
    different moduli N across batch rows)."""
    _check_pair(x, y)
    if _on_kernels(x):
        from ..kernels.ops import mont_mul_op

        return mont_mul_op(x, y, neg, n_hi)
    return _mont_mul_torch(x, y, neg, n_hi)


def _sel(keep0, a: DualRep, b: DualRep) -> DualRep:
    """where(keep0, a, b) element-wise over both bases (keep0: batch bools)."""
    k = keep0[..., None]
    return DualRep(
        a.lo._wrap(torch.where(k, a.lo._cl(), b.lo._cl())),
        a.hi._wrap(torch.where(k, a.hi._cl(), b.hi._cl())),
    )


def ladder_step(r0: DualRep, r1: DualRep, bit, neg, n_hi):
    """One branchless Montgomery-ladder bit (constant-time shape):

        t  = MM(r0, r1);  s = MM(r_bit, r_bit)
        bit=0:  (r0, r1) <- (s, t)        bit=1:  (r0, r1) <- (t, s)

    The select is a data-independent ``where`` — both multiplications run
    for every bit, so the ladder's cost and memory trace never depend on
    the exponent (the classic SPA countermeasure)."""
    if _on_kernels(r0):
        from ..kernels.ops import mont_ladder_op

        return mont_ladder_op(r0, r1, bit, neg, n_hi)
    bit0 = torch.as_tensor(bit, device=r0.lo.device) == 0
    t = _mont_mul_torch(r0, r1, neg, n_hi)
    sq = _sel(bit0, r0, r1)
    s = _mont_mul_torch(sq, sq, neg, n_hi)
    return _sel(bit0, s, t), _sel(bit0, t, s)


def ladder_steps(r0: DualRep, r1: DualRep, bits, neg, n_hi):
    """``bits.shape[-1]`` ladder bits in a row: ``ladder_step`` on
    ``bits[..., i]`` for i = 0, 1, ...  On the kernels' route each bit is
    still one launch, but the operands stay in the kernels' channel-major
    tiles from one launch to the next (``kernels.ops.mont_ladder_steps_op``),
    so the layout and table work is done once, not once a bit."""
    if _on_kernels(r0):
        from ..kernels.ops import mont_ladder_steps_op

        return mont_ladder_steps_op(r0, r1, bits, neg, n_hi)
    bits = torch.as_tensor(bits, device=r0.lo.device)
    for i in range(bits.shape[-1]):
        r0, r1 = ladder_step(r0, r1, bits[..., i], neg, n_hi)
    return r0, r1


# ------------------------------------------------------------ the frontend


class RNSMontgomery:
    """Dual-base Montgomery context for a fixed modulus ``N``.

    ``layout`` picks the B-side redundant channels: ``BASE_MA`` (default —
    enough for the Alg.-1 canonicalization in ``modexp``/``modmul``),
    ``RRNS`` (adds m_b, so the value doubles as a locate-and-correct wire
    codeword), or ``BASE`` (bare legacy layout; ``mul`` works, the
    canonicalizing frontends refuse).  ``device`` holds every operand and
    constant row (default ``"cuda"``, which raises without a card).
    """

    def __init__(self, baseB: RNSBase, baseBp: RNSBase, N: int, *,
                 layout: Layout = Layout.BASE_MA, mb: int | None = None,
                 device="cuda"):
        self.consts = mont_consts(baseB, baseBp, N, layout=layout, mb=mb)
        self.B, self.Bp, self.N = baseB, baseBp, int(N)
        self.layout, self.mb = layout, mb
        self.device = _device(device)
        self._lo_t = _channel_targets(baseB, layout, mb)
        # legacy channel-constant attributes (pre-RnsArray callers)
        self.negNinv_B = self.consts["neg"]
        self.N_Bp = self.consts["n_hi"]
        self.Minv_Bp = minv_residues(baseB, tuple(int(m) for m in baseBp.moduli))
        # the constant rows on the device, uploaded once
        self._c = {k: torch.from_numpy(v).to(self.device)
                   for k, v in self.consts.items()}

    # ------------------------------------------------------- conversions
    def _lo(self, packed) -> RnsArray:
        return RnsArray.from_packed(self.B, packed, mb=self.mb,
                                    device=self.device)

    def _hi(self, packed) -> RnsArray:
        return RnsArray.from_packed(self.Bp, packed, device=self.device)

    def to_dual(self, x: int) -> DualRep:
        """Encode a host big int into both bases (+ redundant channels).
        Exact for ANY magnitude — residues are computed host-side."""
        lo = np.asarray([x % t for t in self._lo_t], dtype=self.B.dtype)
        return DualRep(self._lo(lo), self._hi(self.Bp.residues_of(x)))

    def from_dual(self, d: DualRep) -> int:
        return rns_to_int(self.B, d.xB)

    # ------------------------------------------------------------ algebra
    def mul(self, x: DualRep, y: DualRep, *, approx: bool = False) -> DualRep:
        """Montgomery product X·Y·M^{-1} mod N (result < 2N), batched.

        ``approx=True`` benchmarks the Kawamura floating extension instead
        of exact MRC; its result drops the redundant channels (an
        approximate extension cannot maintain them exactly)."""
        if approx:
            B, Bp = self.B, self.Bp
            q = arith.mul_const(B, arith.mul(B, x.xB, y.xB), self.consts["neg"])
            qp = extend_kawamura(B, q, Bp.moduli)
            t = arith.add(Bp, arith.mul(Bp, x.xBp, y.xBp),
                          arith.mul_const(Bp, qp, self.consts["n_hi"]))
            rp = arith.mul_const(Bp, t, self.Minv_Bp)
            r = extend_mrc(Bp, rp, B.moduli)
            return DualRep(RnsArray.from_packed(B, r, device=r.device),
                           RnsArray.from_packed(Bp, rp, device=rp.device))
        return mont_mul(x, y, self._c["neg"], self._c["n_hi"])

    def _canonicalize(self, lo: RnsArray):
        """Reduce a ``< 2N`` B-side value to ``< N``: one full-range Alg.-1
        comparison against N, then a channel-wise conditional subtract
        (exact in the redundant channels too, since R - N >= 0)."""
        if self.layout is Layout.BASE:
            raise ValueError("canonicalization needs the m_a channel: build "
                             "RNSMontgomery with layout=BASE_MA or RRNS")
        n_lo = self._c["n_lo"].to(lo.dtype)
        ge = lo.compare_ge(self._lo(n_lo))
        m = torch.tensor(self._lo_t, dtype=lo.dtype, device=lo.device)
        d = lo._cl() - n_lo
        d = torch.where(d < 0, d + m, d)
        return torch.where(ge[..., None], d, lo._cl())

    def _m2(self) -> DualRep:
        return DualRep(self._lo(self._c["m2_lo"]), self._hi(self._c["m2_hi"]))

    def modmul(self, a: int, b: int) -> int:
        """``a·b mod N`` via two Montgomery products (enter domain, exit)."""
        neg, n_hi = self._c["neg"], self._c["n_hi"]
        da, db = self.to_dual(a % self.N), self.to_dual(b % self.N)
        abar = mont_mul(da, self._m2(), neg, n_hi)
        out = self._canonicalize(mont_mul(abar, db, neg, n_hi).lo)
        return rns_to_int(self.B, out[..., : self.B.n])

    def modexp(self, a: int, e: int) -> int:
        """``a^e mod N`` by a constant-time Montgomery ladder — bitwise
        equal to ``pow(a, e, N)``.  The ladder runs ``e.bit_length()`` bits
        (at least one), one ``ladder_step`` each."""
        nbits = max(1, int(e).bit_length())
        neg, n_hi = self._c["neg"], self._c["n_hi"]
        abar = mont_mul(self.to_dual(a % self.N), self._m2(), neg, n_hi)
        r0 = DualRep(self._lo(self._c["one_lo"]), self._hi(self._c["one_hi"]))
        r1 = abar
        bits = torch.from_numpy(exp_bits_msb(int(e), nbits)).to(self.device)
        for i in range(nbits):
            r0, r1 = ladder_step(r0, r1, bits[i], neg, n_hi)
        # leave the domain: MM(r0, 1) — literal all-ones residues
        ones = DualRep(
            self._lo(torch.ones(len(self._lo_t), dtype=self.B.tdtype)),
            self._hi(torch.ones(self.Bp.n, dtype=self.Bp.tdtype)))
        out = self._canonicalize(mont_mul(r0, ones, neg, n_hi).lo)
        return rns_to_int(self.B, out[..., : self.B.n])
