"""Batched RNS big-integer crypto service — the serve engine's second
request family (the reference's DESIGN.md §15).

The paper's closing claim is that full-range comparison "opens perspectives
for … division, scaling, and cryptographic applications".  This module is
that claim as a workload: ``modexp`` / ``modmul`` / ``divmod`` requests are
admitted into slots of a continuous-batching lane, advance in fixed-size
ladder chunks under a tick clock, and carry per-slot RRNS fingerprints
verified at retirement.

Execution model:

* ``modexp`` is SLOT-RESIDENT: admission enters the Montgomery domain
  (ā = MM(a, M² mod N)) and writes the slot's ladder state — r0/r1 in both
  bases, the per-``N`` channel constants, and the full fixed-width exponent
  bit row, all DEVICE state.  Each engine tick advances every slot by
  ``chunk`` ladder bits (the bits are gathered per slot at the slot's
  cursor, so the fingerprinted device rows are the actual computation
  inputs).  The ladder always runs its full ``exp_bits`` width —
  leading-zero bits are no-ops (r0 stays 1̄) — so latency is constant and
  exponent-independent (the classic SPA/timing countermeasure), and slot
  residency is the same for every request: ``exp_bits / chunk`` ticks.
* ``modmul`` and ``divmod`` are ONE-SHOT: a single call at admission
  computes and retires them — they never occupy a slot, so they cannot
  starve ladder traffic, and they hold no resident state to fingerprint.

Integrity: a running modexp slot's IMMUTABLE device rows — exponent bits
and the ``N``-derived channel constants — are fingerprinted at admission
(plain + index-weighted f32 sums), RRNS-encoded through the engine's
``GradCodec``, and stored in a ``WireStore`` under the key
``("crypto", rid)``.  At retirement the engine recomputes the fingerprint
from the device rows that fed the ladder and verifies bitwise.

The functions of ``make_crypto_fns`` are plain torch calls on fixed shapes,
with slot ids and cursors as data; on a CUDA state every Montgomery product,
ladder bit and Algorithm-1 comparison runs in the hand-written kernels.

>>> from repro_torch.serve.crypto import CryptoContext, CryptoRequest
>>> ctx = CryptoContext(n_limbs=3, exp_bits=8)
>>> N = 1000003
>>> ctx.validate(CryptoRequest(rid=0, op="modexp", a=7, b=200, n=N))
>>> int(ctx.decode_lo(ctx.encode_lo(12345))) == 12345
True
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from ..core.array import Layout, RnsArray
from ..core.base import RNSBase, gen_coprime_moduli
from ..core.convert import rns_to_int
from ..core.division import _divmod_impl
from ..core.montgomery import (
    DualRep,
    _channel_targets,
    exp_bits_msb,
    ladder_steps,
    mont_consts,
    mont_mul,
)

__all__ = ["CryptoRequest", "CryptoContext", "CryptoLane", "CryptoSlot",
           "make_crypto_fns", "encode_exponent", "CRYPTO_OPS"]

CRYPTO_OPS = ("modexp", "modmul", "divmod")


@dataclasses.dataclass
class CryptoRequest:
    """One big-integer operation.  ``modexp``: a^b mod n; ``modmul``:
    a·b mod n; ``divmod``: (a // b, a % b) over the base's full dynamic
    range [0, M).  ``result`` is engine-filled at retirement: an int, or
    an (q, r) int pair for divmod."""

    rid: int
    op: str
    a: int
    b: int
    n: int | None = None
    arrival: float = 0.0
    family: str = "crypto"
    result: object = None
    slot_index: int | None = None
    t_admit: float | None = None
    t_done: float | None = None


@dataclasses.dataclass
class CryptoSlot:
    index: int
    state: str = "FREE"          # FREE | RUN
    req: CryptoRequest | None = None
    cursor: int = 0              # exponent bits already consumed


class CryptoContext:
    """The crypto lane's algebraic configuration: one dual Montgomery base
    pair shared by every request (the modulus ``N`` is per-request DATA).

    ``n_limbs`` 15-bit channels per base give a ``15·n_limbs``-bit dynamic
    range: requests need ``4·n < M`` and ``2·n < M'``.  Bases are built
    with three extra coprime moduli so the redundant channels (m_a each
    side of the draw, plus m_b for RRNS layouts) are distinct from every
    base channel — full-range comparison with no special-form moduli.
    """

    def __init__(self, *, n_limbs: int = 8, bits: int = 15,
                 exp_bits: int = 32, layout: Layout = Layout.BASE_MA,
                 mb: int | None = None,
                 bases: tuple[RNSBase, RNSBase] | None = None):
        if layout is Layout.BASE:
            raise ValueError("the crypto lane needs the redundant m_a "
                             "channel (Alg.-1 canonicalization): use "
                             "BASE_MA or RRNS")
        if bases is None:
            k = int(n_limbs)
            ms = gen_coprime_moduli(2 * k + 3, bits)
            # interleave so M and M' are within one modulus of each other
            B = RNSBase(moduli=tuple(ms[0:2 * k:2]), ma=ms[2 * k], bits=bits)
            Bp = RNSBase(moduli=tuple(ms[1:2 * k:2]), ma=ms[2 * k + 1],
                         bits=bits)
            if layout is Layout.RRNS and mb is None:
                mb = ms[2 * k + 2]
        else:
            B, Bp = bases
        self.baseB, self.baseBp = B, Bp
        self.layout, self.mb = layout, mb
        self.exp_bits = int(exp_bits)
        self.lo_targets = _channel_targets(B, layout, mb)
        self.nch_lo, self.n, self.n_hi = len(self.lo_targets), B.n, Bp.n
        # largest modulus with bounded Montgomery outputs (exclusive)
        self.n_max = min(B.M // 4, Bp.M // 2)
        self._consts: dict[int, dict] = {}

    def consts_for(self, N: int) -> dict[str, np.ndarray]:
        """Per-``N`` channel-constant rows (cached — traffic reuses moduli)."""
        if N not in self._consts:
            self._consts[N] = mont_consts(self.baseB, self.baseBp, N,
                                          layout=self.layout, mb=self.mb)
        return self._consts[N]

    def encode_lo(self, v: int) -> np.ndarray:
        """(nch_lo,) exact host residues of a big int over all B channels."""
        return np.asarray([v % t for t in self.lo_targets],
                          dtype=self.baseB.dtype)

    def encode_hi(self, v: int) -> np.ndarray:
        return np.asarray(self.baseBp.residues_of(v), dtype=self.baseBp.dtype)

    def decode_lo(self, row) -> int:
        """Exact big int from a (nch_lo,)-or-(n,)-leading row (CRT oracle)."""
        if isinstance(row, torch.Tensor):
            row = row.cpu().numpy()
        return rns_to_int(self.baseB, np.asarray(row)[..., : self.n])

    def validate(self, req: CryptoRequest) -> None:
        """Host-side admission contract; raises ValueError on bad requests."""
        if req.op not in CRYPTO_OPS:
            raise ValueError(f"unknown crypto op {req.op!r}; one of "
                             f"{CRYPTO_OPS}")
        if req.op == "divmod":
            M = self.baseB.M
            if not 0 <= req.a < M:
                raise ValueError(f"divmod dividend must lie in the base's "
                                 f"dynamic range [0, M={M})")
            if not 1 <= req.b < M:
                raise ValueError("divmod divisor must lie in [1, M)")
            return
        if req.n is None:
            raise ValueError(f"{req.op} needs a modulus n=")
        if not 1 < req.n < self.n_max:
            raise ValueError(
                f"modulus n must lie in (1, {self.n_max}) — the bases give "
                f"a {self.baseB.M.bit_length()}-bit range and Montgomery "
                f"needs M > 4n, M' > 2n")
        if math.gcd(req.n, self.baseB.M * self.baseBp.M) != 1:
            raise ValueError("modulus n must be coprime to both base "
                             "products M and M'")
        if req.op == "modexp":
            if req.b < 0 or int(req.b).bit_length() > self.exp_bits:
                raise ValueError(
                    f"exponent needs {int(req.b).bit_length()} bits > the "
                    f"lane's exp_bits={self.exp_bits}")


class CryptoLane:
    """Host-side slot scheduler for the crypto family: a modexp binds a slot
    for exactly ``exp_bits / chunk`` ticks; one-shots never bind."""

    def __init__(self, n_slots: int, exp_bits: int, chunk: int):
        if n_slots < 1:
            raise ValueError("crypto_slots must be >= 1")
        divisors = [d for d in range(1, exp_bits + 1) if exp_bits % d == 0]
        if chunk < 1 or exp_bits % chunk:
            raise ValueError(
                f"crypto_chunk={chunk} must divide exp_bits={exp_bits} "
                f"(the ladder is advanced whole chunks); valid chunks: "
                f"{divisors}")
        self.n_slots, self.exp_bits, self.chunk = n_slots, exp_bits, chunk
        self.slots = [CryptoSlot(i) for i in range(n_slots)]
        self.queue: deque[CryptoRequest] = deque()
        self.completed: list[CryptoRequest] = []

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s.state == "RUN" for s in self.slots)

    def free_slot(self) -> CryptoSlot | None:
        return next((s for s in self.slots if s.state == "FREE"), None)

    def running_slots(self) -> list[CryptoSlot]:
        return [s for s in self.slots if s.state == "RUN"]

    def bind(self, slot: CryptoSlot, req: CryptoRequest, now: float) -> None:
        slot.state, slot.req, slot.cursor = "RUN", req, 0
        req.slot_index, req.t_admit = slot.index, now

    def retire(self, slot: CryptoSlot, now: float) -> CryptoRequest:
        req = slot.req
        req.t_done = now
        self.completed.append(req)
        slot.state, slot.req, slot.cursor = "FREE", None, 0
        return req


def _tree_sum(x):
    """Sums over the last axis of an f32 tensor in a fixed pairwise order
    (zero-padded to a power of two, then halved), so that the same rows on
    the same device always give the same bits."""
    w = x.shape[-1]
    p = 1 << max(0, w - 1).bit_length()
    x = torch.nn.functional.pad(x, (0, p - w))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def make_crypto_fns(ctx: CryptoContext, chunk: int) -> dict:
    """The crypto lane's device functions under the reference's keys
    (``admit``, ``step``, ``final``, ``modmul``, ``divmod``, ``fp``).  Every
    argument keeps a fixed shape (slot ids, cursors and active masks are
    data); the route (plain torch or the CUDA kernels) follows the state's
    device through ``core.dispatch.resolve_backend`` inside
    ``mont_mul``/``ladder_steps`` and the comparisons."""
    B, Bp = ctx.baseB, ctx.baseBp
    lo = lambda p: RnsArray.from_packed(B, p, mb=ctx.mb, device=p.device)
    hi = lambda p: RnsArray.from_packed(Bp, p, device=p.device)
    dual = lambda l, h: DualRep(lo(l), hi(h))
    m_lo = np.asarray(ctx.lo_targets, dtype=B.dtype)

    def at(slot, like):
        """A slot id (int or tensor) as a (1,) index on ``like``'s device."""
        return torch.as_tensor(slot, dtype=torch.long,
                               device=like.device).reshape(1)

    def canonical(ex_lo: RnsArray, n_lo_rows):
        """< 2N -> < N: full-range Alg.-1 compare vs N + conditional
        channel-wise subtract (exact in the redundant channels too)."""
        ge = ex_lo.compare_ge(lo(n_lo_rows))
        d = ex_lo._cl() - n_lo_rows.to(ex_lo.dtype)
        m = torch.from_numpy(m_lo).to(device=d.device, dtype=d.dtype)
        d = torch.where(d < 0, d + m, d)
        return torch.where(ge[..., None], d, ex_lo._cl())

    def admit(state, slot, a_lo, a_hi, m2_lo, m2_hi, one_lo, one_hi,
              neg, n_lo, n_hi, bits):
        """Enter the Montgomery domain and write slot ``slot``'s ladder
        state; every row argument is (1, width).  Returns the new state (the
        input state's tensors are not modified)."""
        abar = mont_mul(dual(a_lo, a_hi), dual(m2_lo, m2_hi), neg, n_hi)
        upd = {"r0_lo": one_lo, "r0_hi": one_hi,
               "r1_lo": abar.lo.to_packed(), "r1_hi": abar.hi.to_packed(),
               "neg": neg, "n_lo": n_lo, "n_hi": n_hi, "bits": bits}
        rows = torch.arange(state["bits"].shape[0], device=a_lo.device)
        hit = (rows == at(slot, state["bits"]))[:, None]
        out = dict(state)
        for k, v in upd.items():
            out[k] = torch.where(hit, v.to(state[k].dtype), state[k])
        return out

    def step(state, cursors, active):
        """Advance EVERY slot row ``chunk`` ladder bits; rows with
        ``active == 0`` are restored bitwise untouched at the end (one
        masked select per output, so co-residency never perturbs a
        neighbour)."""
        width = state["bits"].shape[1]
        # a window of ``chunk`` bits at each cursor, the start clamped into
        # the row as a dynamic slice clamps it
        start = cursors.to(torch.long).clamp(0, width - chunk)
        cols = start[:, None] + torch.arange(chunk, device=start.device)
        bits = torch.gather(state["bits"], 1, cols)             # (S, chunk)
        r0 = dual(state["r0_lo"], state["r0_hi"])
        r1 = dual(state["r1_lo"], state["r1_hi"])
        r0, r1 = ladder_steps(r0, r1, bits, state["neg"], state["n_hi"])
        keep = active[:, None].to(torch.bool)
        sel = lambda new, old: torch.where(keep, new.to(old.dtype), old)
        return {**state,
                "r0_lo": sel(r0.lo.to_packed(), state["r0_lo"]),
                "r0_hi": sel(r0.hi.to_packed(), state["r0_hi"]),
                "r1_lo": sel(r1.lo.to_packed(), state["r1_lo"]),
                "r1_hi": sel(r1.hi.to_packed(), state["r1_hi"])}

    def final(state, slot):
        """Leave the domain (MM(r0, 1)) and canonicalize to < N; returns
        the (1, nch_lo) result row."""
        idx = at(slot, state["bits"])
        row = lambda k: state[k].index_select(0, idx)
        r0 = dual(row("r0_lo"), row("r0_hi"))
        dev = state["r0_lo"].device
        ones = dual(torch.ones((1, ctx.nch_lo), dtype=r0.lo.dtype, device=dev),
                    torch.ones((1, ctx.n_hi), dtype=r0.hi.dtype, device=dev))
        ex = mont_mul(r0, ones, row("neg"), row("n_hi"))
        return canonical(ex.lo, row("n_lo"))

    def modmul(a_lo, a_hi, b_lo, b_hi, m2_lo, m2_hi, neg, n_hi, n_lo):
        """One-shot a·b mod N: enter the domain, one product, leave."""
        abar = mont_mul(dual(a_lo, a_hi), dual(m2_lo, m2_hi), neg, n_hi)
        r = mont_mul(abar, dual(b_lo, b_hi), neg, n_hi)
        return canonical(r.lo, n_lo)

    def divmod_fn(xp, dp):
        """One-shot full-range (a // b, a % b) via the comparison-driven
        division (core/division.py) on (1, n+1) Alg.-1 packed rows."""
        return _divmod_impl(B, xp, dp)

    def fp(state, slot):
        """(8,) f32 fingerprint of slot ``slot``'s IMMUTABLE rows (bits +
        the three N-derived constant rows): plain and index-weighted sums,
        as the reference forms them, each reduced in a fixed pairwise
        order.  The sums are exact only while they stay below 2**24: at
        the RSA-2048 width (nch_lo = 139) the weighted ``n_lo`` sum can
        reach 318,822,910 and is rounded (ROADMAP, queue 3)."""
        idx = at(slot, state["bits"])
        rows = []
        for k in ("bits", "neg", "n_lo", "n_hi"):
            row = state[k].index_select(0, idx)[0].to(torch.float32)
            w = torch.arange(1, row.shape[0] + 1, dtype=torch.float32,
                             device=row.device)
            rows += [row, row * w]
        width = max(r.shape[0] for r in rows)
        pad = [torch.nn.functional.pad(r, (0, width - r.shape[0]))
               for r in rows]
        return _tree_sum(torch.stack(pad))

    return {"admit": admit, "step": step, "final": final, "modmul": modmul,
            "divmod": divmod_fn, "fp": fp}


def encode_exponent(ctx: CryptoContext, e: int) -> np.ndarray:
    """(exp_bits,) MSB-first fixed-width bit row for the device state."""
    return exp_bits_msb(int(e), ctx.exp_bits)
