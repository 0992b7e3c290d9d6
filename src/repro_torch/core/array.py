"""``RnsArray`` — the paper's representation as one typed torch value.

* ``residues`` — an int tensor carrying every channel, either channels-LAST
  (``channel_axis=-1``, the algebraic layout) or channels-FIRST
  (``channel_axis=0``, the kernels' native ``(n, B)`` tile layout: a
  contiguous channel-major int32 tensor reaches the CUDA kernels without a
  transpose copy).
* ``layout`` — how many redundant channels ride along: ``BASE`` (none),
  ``BASE_MA`` (the paper's ``m_a``), ``RRNS`` (``m_a`` + ``m_b``; ``mb``
  holds the second modulus since ``RNSBase`` only carries ``m_a``).
* ``signed`` — whether the value uses the signed embedding ``v -> v mod M``
  with ``|v| < M/2``.

Every method routes through the backend resolver (core/dispatch.py): the
hand-written CUDA kernels (kernels/ops.py) for a CUDA tensor on an
int32-lane base, plain torch otherwise.  The constructors take ``device=``,
which defaults to ``"cuda"`` and raises when no card is present.

Tour (on the CPU)::

    >>> import torch
    >>> from repro_torch.core import RnsArray, Layout, make_base
    >>> base = make_base(4, bits=8)
    >>> a = RnsArray.encode(base, [1000, 77], device="cpu")
    >>> b = RnsArray.encode(base, [999, 78], device="cpu")
    >>> a.layout, a.n_channels                  # residues + m_a channel
    (<Layout.BASE_MA: 'base_ma'>, 5)
    >>> (a >= b).tolist()                       # Algorithm 1, one MRC each
    [True, False]
    >>> (a - b).to_int().tolist()               # exact; signed result view
    [1, -1]
    >>> q, r = a.divmod(b)                      # comparison-driven division
    >>> q.to_int().tolist(), r.to_int().tolist()
    ([1, 0], [1, 77])
    >>> s = RnsArray.encode_signed(base, [-3, 5], device="cpu")
    >>> s.is_negative().tolist()                # sign = ONE comparison
    [True, False]
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .base import RNSBase
from .compare import compare_ge_routed
from .dispatch import resolve_backend
from .mrc import mrc_routed

__all__ = ["Layout", "RnsArray"]


class Layout(enum.Enum):
    """Channel inventory of an ``RnsArray`` buffer.

    BASE     — ``n`` base residue channels only (ring arithmetic, MRC).
    BASE_MA  — ``n + 1``: base + the paper's redundant ``m_a`` channel
               (enables Algorithm-1 comparison and everything built on it).
    RRNS     — ``n + 2``: base + ``m_a`` + ``m_b``, the locate-and-correct
               redundant pair.
    """

    BASE = "base"
    BASE_MA = "base_ma"
    RRNS = "rrns"

    @property
    def n_redundant(self) -> int:
        return {Layout.BASE: 0, Layout.BASE_MA: 1, Layout.RRNS: 2}[self]


def _device(device) -> torch.device:
    """The constructors' target device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "RnsArray: no CUDA device is available; pass device='cpu' to "
            "run on the host"
        )
    return device


def _as_tensor(values, device) -> torch.Tensor:
    """Integer input (tensor, numpy array or nested ints) on ``device``;
    plain Python ints become int64."""
    if isinstance(values, torch.Tensor):
        return values.to(_device(device))
    if not isinstance(values, np.ndarray):
        values = np.asarray(values, dtype=np.int64)
    return torch.tensor(values, device=_device(device))


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class RnsArray:
    """A batched RNS value: one residue tensor + static representation info.

    Construct via the classmethods (``encode``, ``encode_signed``,
    ``from_packed``, ``from_parts``, ``from_numpy``) rather than the raw
    constructor — they compute consistent redundant channels for you.
    """

    residues: torch.Tensor
    base: RNSBase
    layout: Layout = Layout.BASE_MA
    signed: bool = False
    channel_axis: int = -1          # -1 = channels-last, 0 = channel-major
    mb: int | None = None           # second redundant modulus (RRNS only)

    def __post_init__(self):
        if self.channel_axis not in (0, -1):
            raise ValueError("channel_axis must be 0 or -1")
        if self.layout is Layout.RRNS and self.mb is None:
            raise ValueError("RRNS layout needs the second redundant "
                             "modulus: pass mb=")
        if self.layout is not Layout.RRNS and self.mb is not None:
            raise ValueError(f"mb is only meaningful for RRNS, not "
                             f"{self.layout}")
        shape = self.residues.shape
        if len(shape) > 0 and shape[self.channel_axis] != self.n_channels:
            raise ValueError(
                f"residues carry {shape[self.channel_axis]} channels at "
                f"axis {self.channel_axis}, but layout {self.layout} on "
                f"an n={self.base.n} base needs {self.n_channels}"
            )

    # -------------------------------------------------------- shape & views
    @property
    def n_channels(self) -> int:
        return self.base.n + self.layout.n_redundant

    @property
    def redundant_moduli(self) -> tuple[int, ...]:
        """Redundant channel moduli in channel order: (), (m_a,) or
        (m_a, m_b)."""
        return ((), (self.base.ma,), (self.base.ma, self.mb))[
            self.layout.n_redundant
        ]

    @property
    def channel_moduli(self) -> np.ndarray:
        """(n_channels,) modulus per channel, base then redundant."""
        return self.base.moduli_with(self.redundant_moduli)

    @property
    def shape(self) -> tuple[int, ...]:
        """Batch shape (the channel axis removed)."""
        s = tuple(self.residues.shape)
        return s[1:] if self.channel_axis == 0 else s[:-1]

    @property
    def dtype(self):
        return self.residues.dtype

    @property
    def device(self) -> torch.device:
        return self.residues.device

    def _cl(self):
        """Residues with channels LAST regardless of storage layout."""
        if self.channel_axis == 0:
            return torch.movedim(self.residues, 0, -1)
        return self.residues

    def _wrap(self, buf_cl, **overrides):
        """Rebuild an RnsArray from a channels-last buffer, preserving the
        storage layout and aux (unless overridden)."""
        aux = dict(layout=self.layout, signed=self.signed,
                   channel_axis=self.channel_axis, mb=self.mb)
        aux.update(overrides)
        if aux["channel_axis"] == 0:
            buf_cl = torch.movedim(buf_cl, -1, 0)
        return RnsArray(buf_cl, self.base, **aux)

    @property
    def x(self):
        """Base residue channels, channels-last ``(..., n)``."""
        return self._cl()[..., : self.base.n]

    @property
    def xa(self):
        """The redundant ``m_a`` channel ``(...,)`` (BASE_MA/RRNS only)."""
        self._need_ma("xa")
        return self._cl()[..., self.base.n]

    def to_packed(self):
        """The channels-last buffer ``(..., n_channels)``."""
        return self._cl()

    def with_channel_axis(self, axis: int) -> "RnsArray":
        """Same value, channels moved to ``axis`` (0 or -1)."""
        if axis == self.channel_axis:
            return self
        return self._wrap(self._cl(), channel_axis=axis)

    def to(self, device) -> "RnsArray":
        """Same value with its residues on ``device``."""
        return dataclasses.replace(self, residues=self.residues.to(device))

    def __repr__(self):
        return (f"RnsArray(residues={self.residues!r}, n={self.base.n}, "
                f"layout={self.layout.name}, signed={self.signed}, "
                f"channel_axis={self.channel_axis})")

    def _need_ma(self, what: str):
        if self.layout is Layout.BASE:
            raise ValueError(
                f"{what} needs the redundant m_a channel: this RnsArray has "
                f"layout BASE — use .normalize(Layout.BASE_MA) to extend"
            )

    def _m_like(self, ref):
        return self.base.tensor(("moduli_with", self.redundant_moduli),
                                ref.device, ref.dtype)

    # --------------------------------------------------- ring arithmetic
    def _lift(self, other) -> "RnsArray":
        if isinstance(other, RnsArray):
            if other.base is not self.base and other.base != self.base:
                raise ValueError("RnsArray ops need matching bases")
            if other.layout is not self.layout or other.mb != self.mb:
                raise ValueError(
                    f"RnsArray ops need matching layouts: "
                    f"{self.layout} vs {other.layout}"
                )
            return other.with_channel_axis(self.channel_axis)
        if isinstance(other, (int, np.integer)):
            # channel-wise residues of the constant, broadcast over batch
            v = int(other) % self.base.M
            res = torch.tensor([v % int(m) for m in self.channel_moduli],
                               dtype=self.dtype, device=self.device)
            return RnsArray(
                res.expand(*self.shape, self.n_channels),
                self.base, layout=self.layout, signed=self.signed,
                channel_axis=-1, mb=self.mb,
            ).with_channel_axis(self.channel_axis)
        return NotImplemented

    def __add__(self, other) -> "RnsArray":
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        a, b = self._cl(), other._cl()
        m = self._m_like(a)
        s = a + b
        out = torch.where(s >= m, s - m, s)  # both reduced => s in [0, 2m)
        return self._wrap(out, signed=self.signed or other.signed)

    def __sub__(self, other) -> "RnsArray":
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        a, b = self._cl(), other._cl()
        m = self._m_like(a)
        d = a - b
        out = torch.where(d < 0, d + m, d)
        return self._wrap(out, signed=True)

    def __neg__(self) -> "RnsArray":
        a = self._cl()
        m = self._m_like(a)
        return self._wrap(torch.where(a == 0, a, m - a), signed=True)

    def __mul__(self, other) -> "RnsArray":
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        if resolve_backend(self.residues, self.base) == "cuda":
            from ..kernels.ops import modmul_op

            return modmul_op(self, other)
        a, b = self._cl(), other._cl()
        out = torch.remainder(a * b, self._m_like(a))
        return self._wrap(out, signed=self.signed or other.signed)

    __radd__ = __add__
    __rmul__ = __mul__

    def __rsub__(self, other):
        lifted = self._lift(other)
        if lifted is NotImplemented:
            return NotImplemented
        return lifted - self

    # NOTE on redundant channels under arithmetic: each channel computes in
    # its OWN modulus, so after the base value wraps mod M the carried
    # m_a/m_b channels track the UN-wrapped integer.  Re-anchor with
    # ``normalize()`` before Algorithm-1 queries if wraps may have occurred.

    # ------------------------------------------------------- comparisons
    def compare_ge(self, other, *, unroll: bool = False):
        """Algorithm 1 / Theorem 1: elementwise ``self >= other`` over the
        full range [0, M).  One MRC + one Alg.-3 dot; the fused CUDA kernel
        on the card."""
        self._need_ma("compare_ge")
        other = self._lift(other)
        if other is NotImplemented:
            raise TypeError("compare_ge needs an RnsArray (or int) operand")
        return compare_ge_routed(
            self.base, self.x, self.xa, other.x, other.xa, unroll=unroll
        )

    def __ge__(self, other):
        lifted = self._lift(other)
        if lifted is NotImplemented:
            return NotImplemented
        return self.compare_ge(lifted)

    def __le__(self, other):
        other = self._lift(other)
        if other is NotImplemented:
            return NotImplemented
        return other.compare_ge(self)

    def __gt__(self, other):
        le = self.__le__(other)
        return NotImplemented if le is NotImplemented else ~le

    def __lt__(self, other):
        ge = self.__ge__(other)
        return NotImplemented if ge is NotImplemented else ~ge

    def is_negative(self):
        """Sign of a signed-embedded value: ONE Alg.-1 comparison against
        ceil(M/2)."""
        self._need_ma("is_negative")
        if not self.signed:
            raise ValueError("is_negative needs signed=True (the unsigned "
                             "range [0, M) has no sign)")
        from .signed import _is_negative_impl

        return _is_negative_impl(self.base, self._alg1_packed())

    def abs_ge(self, thr: int):
        """|value| >= thr for signed embeddings: two Alg.-1 comparisons."""
        self._need_ma("abs_ge")
        if not self.signed:
            raise ValueError("abs_ge needs signed=True")
        from .signed import _abs_ge_impl

        return _abs_ge_impl(self.base, self._alg1_packed(), int(thr))

    def _alg1_packed(self):
        """The (..., n+1) channels-last slice Algorithm-1 consumers eat —
        base residues + m_a (the RRNS m_b channel plays no part)."""
        return self._cl()[..., : self.base.n + 1]

    # ------------------------------------------------------- conversions
    def to_mrs(self):
        """Mixed-radix digits ``(..., n)`` (Alg. 2; the kernel on the card)."""
        return mrc_routed(self.base, self.x)

    def to_int(self):
        """Exact int64 values (requires M < 2**62; signed-aware).

        >>> from repro_torch.core import RnsArray, make_base
        >>> base = make_base(3, bits=15)
        >>> v = [123456789, -42]
        >>> RnsArray.encode_signed(base, v, device="cpu").to_int().tolist()
        [123456789, -42]
        """
        from .convert import rns_to_tensor

        v = rns_to_tensor(self.base, self.x)
        if self.signed:
            half = (self.base.M + 1) // 2
            v = torch.where(v >= half, v - self.base.M, v)
        return v

    def extend(self, targets: tuple[int, ...]):
        """Exact MRC base extension: residues of the value mod each target
        modulus, shape ``(..., T)``."""
        from .extend import _extend_mrc_impl

        return _extend_mrc_impl(self.base, self.x, tuple(int(t) for t in targets))

    def normalize(self, layout: Layout | None = None, *,
                  mb: int | None = None) -> "RnsArray":
        """Recompute the redundant channels from the base residues (one MRC
        + one Alg.-3 dot per channel).  Re-anchors m_a/m_b after ring wraps;
        also converts BETWEEN layouts (pass ``layout=``, and ``mb=`` when
        lifting to RRNS)."""
        layout = self.layout if layout is None else layout
        if layout is Layout.RRNS:
            mb = self.mb if mb is None else mb
            if mb is None:
                raise ValueError("normalize to RRNS needs mb=")
        else:
            mb = None
        reds = ((), (self.base.ma,), (self.base.ma, mb))[layout.n_redundant]
        x = self.x
        if not reds:
            return self._wrap(x, layout=layout, mb=None)
        from .convert import mrs_dot_mod

        xr = mrs_dot_mod(self.base, self.to_mrs(), reds)
        return self._wrap(torch.cat([x, xr.to(x.dtype)], dim=-1),
                          layout=layout, mb=mb)

    # ------------------------------------------------- scaling & division
    def halve(self) -> "RnsArray":
        """Exact floor(X/2): parity via the mixed-radix digit sum, then
        multiply by 2^{-1} per channel.  Unsigned only."""
        if self.signed:
            raise ValueError("halve/scale_pow2 are defined on unsigned "
                             "ranges; strip signs first")
        from .division import _halve_impl

        return self._wrap(
            _halve_impl(self.base, self._cl(), self.redundant_moduli)
        )

    def scale_pow2(self, k: int) -> "RnsArray":
        """Exact floor(X / 2^k): k chained halvings."""
        out = self
        for _ in range(int(k)):
            out = out.halve()
        return out

    def divmod(self, other) -> tuple["RnsArray", "RnsArray"]:
        """(Q, R) with X = Q·D + R, 0 <= R < D, entirely in RNS — restoring
        division where every magnitude decision is one Algorithm-1
        comparison (2·nbits+1 of them).  Unsigned operands only."""
        self._need_ma("divmod")
        other = self._lift(other)
        if other is NotImplemented:
            raise TypeError("divmod needs an RnsArray (or int) divisor")
        if self.signed or other.signed:
            raise ValueError("divmod is defined on unsigned ranges; "
                             "strip signs first")
        from .division import _divmod_impl

        q, r = _divmod_impl(
            self.base, self._alg1_packed(), other._alg1_packed()
        )
        if self.layout is Layout.RRNS:
            # quotient/remainder carry fresh m_a channels; rebuild m_b
            def lift(p):
                return RnsArray(p, self.base, layout=Layout.BASE_MA).normalize(
                    Layout.RRNS, mb=self.mb
                ).with_channel_axis(self.channel_axis)
        else:
            lift = self._wrap
        return lift(q), lift(r)

    # ------------------------------------------------------- constructors
    @classmethod
    def encode(cls, base: RNSBase, values, *,
               layout: Layout = Layout.BASE_MA,
               mb: int | None = None,
               channel_axis: int = -1,
               device="cuda") -> "RnsArray":
        """Unsigned integer values in [0, M), int64-ranged -> residues +
        consistent redundant channels.

        >>> from repro_torch.core import RnsArray, make_base
        >>> base = make_base(4, bits=8)
        >>> a = RnsArray.encode(base, [1234], device="cpu")
        >>> int(a.xa[0]) == 1234 % base.ma
        True
        """
        from .convert import tensor_to_rns

        values = _as_tensor(values, device)
        res = tensor_to_rns(base, values)
        if layout is Layout.RRNS and mb is None:
            raise ValueError("encode to RRNS needs mb=")
        reds = ((), (base.ma,), (base.ma, mb))[layout.n_redundant]
        cols = [res]
        for mr in reds:
            cols.append(torch.remainder(values.to(torch.int64), mr)[..., None]
                        .to(res.dtype))
        return cls(
            torch.cat(cols, dim=-1) if reds else res,
            base, layout=layout, signed=False, channel_axis=-1,
            mb=mb if layout is Layout.RRNS else None,
        ).with_channel_axis(channel_axis)

    @classmethod
    def encode_signed(cls, base: RNSBase, values, *,
                      channel_axis: int = -1, device="cuda") -> "RnsArray":
        """Signed integer values (|v| < M/2) -> signed embedding with a
        consistent m_a channel."""
        from .signed import _encode_signed_impl

        packed = _encode_signed_impl(base, _as_tensor(values, device))
        return cls(
            packed, base, layout=Layout.BASE_MA, signed=True,
            channel_axis=-1,
        ).with_channel_axis(channel_axis)

    @classmethod
    def from_packed(cls, base: RNSBase, packed, *, signed: bool = False,
                    mb: int | None = None,
                    channel_axis: int = -1, device="cuda") -> "RnsArray":
        """Lift a buffer: ``(..., n)`` (BASE), ``(..., n+1)`` (BASE_MA) or
        ``(..., n+2)`` (RRNS, needs ``mb=``) at ``channel_axis``.  The
        redundant channels are taken AS IS — no consistency check."""
        packed = _as_tensor(packed, device)
        extra = packed.shape[channel_axis] - base.n
        if not 0 <= extra <= 2:
            raise ValueError(
                f"buffer carries {packed.shape[channel_axis]} channels; an "
                f"n={base.n} base expects n, n+1 or n+2"
            )
        layout = (Layout.BASE, Layout.BASE_MA, Layout.RRNS)[extra]
        return cls(packed, base, layout=layout, signed=signed,
                   channel_axis=channel_axis,
                   mb=mb if layout is Layout.RRNS else None)

    @classmethod
    def from_parts(cls, base: RNSBase, x, xa=None, *,
                   device="cuda") -> "RnsArray":
        """Lift separate base residues ``x: (..., n)`` and (optionally) the
        redundant residue ``xa: (...,)``."""
        x = _as_tensor(x, device)
        if xa is None:
            return cls(x, base, layout=Layout.BASE)
        xa = _as_tensor(xa, device)
        return cls(torch.cat([x, xa[..., None].to(x.dtype)], dim=-1),
                   base, layout=Layout.BASE_MA)

    @classmethod
    def from_numpy(cls, moduli, ma, bits, residues, *,
                   layout: Layout = Layout.BASE_MA, signed: bool = False,
                   channel_axis: int = -1, mb: int | None = None,
                   device="cuda") -> "RnsArray":
        """Rebuild a value from the reference's fields as numpy data: the
        base (``moduli``, ``ma``, ``bits``) and the residue buffer with its
        representation info.  This is how state crosses between the two
        packages."""
        base = RNSBase(moduli=tuple(int(m) for m in np.asarray(moduli)),
                       ma=int(ma), bits=int(bits))
        return cls(_as_tensor(np.asarray(residues), device), base,
                   layout=Layout(getattr(layout, "value", layout)),
                   signed=bool(signed), channel_axis=int(channel_axis),
                   mb=None if mb is None else int(mb))
