"""RNS gradient codec: exact distributed gradient aggregation (paper §4-5).

fp32 gradients quantize to fixed point (``frac_bits`` fractional bits), embed
signed into the RNS ring (residue channels for the base plus the paper's
redundant ``m_a`` channel), and all-reduce PER CHANNEL as plain int32 sums.
The channel sum of encodings is the encoding of the sum while the summed
magnitude stays below M/2, so the decode after the all-reduce recovers the
EXACT integer sum of the quantized per-replica gradients — the same bits
whatever the reduction order, unlike an fp32 all-reduce.

The redundant channel rides along through every ring op, so sign tests,
magnitude clips and consistency checks are single Algorithm-1 comparisons —
no reconstruction.  With a SECOND redundant modulus (``make(correct=True)``)
the code is a Redundant RNS that can locate and correct any single
corrupted channel: ``locate_fault`` / ``correct_packed`` /
``repair_columns_``, each one call of ``kernels.ops.rrns_repair_op`` (the
repair kernel on the card, its plain version elsewhere).

Layouts:

* **leaf-major** ``(..., n_channels)``: channels last, the algebraic API's
  layout (``fold``/``normalize``/``decode``/``verify_packed``/...).
* **channel-major** ``(n_channels, B)``: one contiguous row per channel —
  the kernels' layout and the wire format of the bucketed transport.

Both lift into ``repro_torch.core.RnsArray`` (layout BASE_MA for a detect
codec, RRNS for locate-and-correct; ``channel_axis=0`` is the wire layout).

Transport: ``rns_psum`` moves one tensor, ``rns_psum_tree`` a whole gradient
tree bucketed into ONE channel-major int32 buffer, in a single
``torch.distributed.all_reduce(SUM)``.  Encode and decode run the codec
kernels (kernels/ops.py: the CUDA kernels for a CUDA tensor, their plain
versions for a CPU one) when ``use_fused`` holds, else the exact f64 path —
the same bits either way.

    >>> import torch
    >>> from repro_torch.dist.grad_codec import GradCodec
    >>> codec = GradCodec.make(world=2)          # 3 base channels + m_a
    >>> codec.n_channels
    4
    >>> packed = codec.encode(torch.tensor([1.5, -0.25]))   # leaf-major
    >>> tuple(packed.shape)
    (2, 4)
    >>> codec.decode(codec.fold(packed)).tolist()
    [1.5, -0.25]
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..core.array import Layout, RnsArray
from ..core.base import RNSBase, gen_coprime_moduli, make_base
from ..core.compare import compare_packed_ge
from ..core.convert import mrs_dot_mod, rns_to_tensor
from ..core.dispatch import get_backend, resolve_backend
from ..core.mrc import mrc_unrolled
from ..core.signed import abs_ge_threshold, encode_signed, is_negative
from ..spans import span
from . import _tree

__all__ = ["GradCodec", "rns_psum", "rns_psum_tree", "tree_pack",
           "tree_pack_rns", "tree_decode"]


@dataclasses.dataclass(frozen=True)
class GradCodec:
    """Static codec configuration (hashable).

    ``mb`` is the optional SECOND redundant modulus (``make(correct=True)``):
    the packed layout then grows to ``(..., n+2)`` and the codec can
    locate-and-correct a single corrupted channel, not only detect one.
    """

    base: RNSBase
    frac_bits: int
    world: int
    fused: bool = True
    mb: int | None = None

    @classmethod
    def make(cls, *, world: int, n: int = 3, bits: int = 15,
             frac_bits: int = 16, fused: bool = True,
             correct: bool = False) -> "GradCodec":
        """Codec sized for ``world`` replicas: per-replica magnitudes up to
        ``qmax`` sum without leaving the signed range (-M/2, M/2).

        ``correct=True`` adds the second redundant modulus ``m_b``; the
        redundant pair is then the two LARGEST primes of the generated set,
        which the locate test's exactness needs (m_a * m_b > m_c * m_e for
        every pair of surviving channels).

        >>> GradCodec.make(world=2).n_channels          # detect-only
        4
        >>> rrns = GradCodec.make(world=2, correct=True)
        >>> rrns.n_channels, rrns.mb is not None        # locate-and-correct
        (5, True)
        """
        if world < 1:
            raise ValueError("world must be >= 1")
        mb = None
        if correct:
            ms = gen_coprime_moduli(n + 2, bits=bits)  # descending primes
            base = RNSBase(moduli=tuple(ms[2:]), ma=ms[0], bits=bits)
            mb = ms[1]
        else:
            base = make_base(n, bits=bits)
        codec = cls(base=base, frac_bits=frac_bits, world=world, fused=fused,
                    mb=mb)
        if codec.qmax < 1:
            raise ValueError(
                f"world={world} leaves no dynamic range for base M={base.M}"
            )
        return codec

    @property
    def redundant(self) -> tuple[int, ...]:
        """The redundant moduli, in channel order: (m_a,) or (m_a, m_b)."""
        return (self.base.ma,) if self.mb is None else (self.base.ma, self.mb)

    @property
    def layout(self) -> Layout:
        """The ``RnsArray`` layout of this codec's buffers: BASE_MA for a
        detect-only codec, RRNS for locate-and-correct."""
        return Layout.BASE_MA if self.mb is None else Layout.RRNS

    def as_array(self, buf, *, channel_major: bool = False) -> RnsArray:
        """Lift a raw packed buffer (leaf-major ``(..., n_channels)`` or
        wire-layout ``(n_channels, B)``) into a typed ``RnsArray`` on the
        buffer's own device."""
        return RnsArray.from_packed(
            self.base, buf, signed=True, mb=self.mb,
            channel_axis=0 if channel_major else -1, device=buf.device,
        )

    def _split(self, p):
        """(channels-last buffer, RnsArray-or-None) for dual-API methods."""
        if isinstance(p, RnsArray):
            return p.to_packed(), p
        return p, None

    @staticmethod
    def _rejoin(buf_cl, proto):
        """The caller's type back: an RnsArray in ``proto``'s storage layout
        when the input was typed, the raw buffer otherwise."""
        if proto is None:
            return buf_cl
        return RnsArray(
            buf_cl, proto.base, layout=proto.layout, signed=proto.signed,
            channel_axis=-1, mb=proto.mb,
        ).with_channel_axis(proto.channel_axis)

    @property
    def n_channels(self) -> int:
        """Total packed channels: n base + 1 or 2 redundant."""
        return self.base.n + len(self.redundant)

    @property
    def use_fused(self) -> bool:
        """True when the transport runs the codec kernels: the knob is on
        AND the base fits their limb discipline (15-bit int32 lanes,
        M < 2**45).  Wider bases take the exact f64 path — the same bits.

        >>> GradCodec.make(world=2).use_fused        # 3 x 15 bits
        True
        >>> GradCodec.make(world=2, n=4).use_fused   # M ~ 2**60
        False

        A ``repro_torch.core.backend(...)`` context overrides the codec's
        own ``fused`` flag: "torch" forces the f64 path, "cuda" opts a
        qualifying base in even when the codec was built ``fused=False``.

        >>> from repro_torch.core import backend
        >>> with backend("torch"):
        ...     GradCodec.make(world=2).use_fused
        False
        """
        setting = get_backend()
        if setting == "torch":
            return False
        want = self.fused or setting == "cuda"
        return want and self.base.bits <= 15 and self.base.M < (1 << 45)

    def _kernels(self, t) -> bool:
        """Whether an encode/decode of tensor ``t`` takes the codec kernels;
        under ``backend("cuda")`` a host tensor raises, as everywhere."""
        if not self.use_fused:
            return False
        resolve_backend(t, self.base)
        return True

    @property
    def qmax(self) -> int:
        """Max per-replica quantized magnitude (world of them sum exactly)."""
        return (self.base.M - 1) // (2 * self.world)

    @property
    def clip(self) -> float:
        """Float clip range implied by qmax at the quantization step."""
        return self.qmax / (1 << self.frac_bits)

    # ----------------------------------------------------------- transport
    def encode(self, g):
        """fp32 tensor (...,) -> packed int residue tensor, leaf-major
        ``(..., n_channels)``: the exact f64 path.

        A NaN quantizes to 0, as the reference's NaN-to-int conversion
        gives (torch leaves that conversion undefined, so it is explicit).

        >>> import torch
        >>> codec = GradCodec.make(world=2)
        >>> tuple(codec.encode(torch.tensor([0.5])).shape)
        (1, 4)
        """
        r = torch.round(g.to(torch.float64) * (1 << self.frac_bits))
        r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
        q = torch.clamp(r, -float(self.qmax), float(self.qmax)).to(torch.int64)
        packed = encode_signed(self.base, q)
        if self.mb is None:
            return packed
        # second redundant channel: (q mod M) mod m_b, same signed shift
        xb = torch.remainder(q, self.mb)
        xb = torch.where(
            q < 0, torch.remainder(xb + self.base.M % self.mb, self.mb), xb
        )
        return torch.cat([packed, xb[..., None].to(packed.dtype)], dim=-1)

    def encode_packed(self, g, *, channel_major: bool = False, out=None):
        """Transport-path encode: the codec kernel when ``use_fused`` else
        the f64 path — the same residues either way.

        ``channel_major=True`` returns the contiguous ``(n_channels, B)``
        wire layout of the flattened input, written into ``out`` when
        given (an int32 tensor of that shape); the default is leaf-major.

        >>> import torch
        >>> codec = GradCodec.make(world=2)
        >>> tuple(codec.encode_packed(torch.ones(2, 3)).shape)
        (2, 3, 4)
        >>> tuple(codec.encode_packed(torch.ones(6), channel_major=True).shape)
        (4, 6)
        """
        if self._kernels(g):
            from ..kernels.ops import codec_encode_op

            return codec_encode_op(self, g, channel_major=channel_major,
                                   out=out)
        if out is not None and not channel_major:
            raise ValueError("encode_packed: out= takes the channel-major "
                             "layout")
        if channel_major:
            wire = self.encode(g.reshape(-1)).T
            return wire.contiguous() if out is None else out.copy_(wire)
        return self.encode(g)

    def encode_array(self, g, *, channel_major: bool = False) -> RnsArray:
        """``encode_packed`` lifted into an ``RnsArray`` (layout BASE_MA or
        RRNS, ``signed=True``, channel-major storage for the wire).

        >>> import torch
        >>> arr = GradCodec.make(world=2, correct=True).encode_array(
        ...     torch.ones(6), channel_major=True)
        >>> arr.layout.name, tuple(arr.residues.shape)
        ('RRNS', (5, 6))
        """
        return self.as_array(
            self.encode_packed(g, channel_major=channel_major),
            channel_major=channel_major,
        )

    def decode_summed(self, summed, *, channel_major: bool = False):
        """Transport-path decode of per-channel sums: the codec kernel when
        ``use_fused`` else fold + decode — the same f32 either way.
        ``summed`` may be raw (``channel_major`` says which layout) or an
        ``RnsArray`` (layout read off the type)."""
        if isinstance(summed, RnsArray):
            channel_major = summed.channel_axis == 0
            summed = summed.residues
        if self._kernels(summed):
            from ..kernels.ops import codec_decode_op

            return codec_decode_op(self, summed, channel_major=channel_major)
        return self.decode(self.fold(summed.T if channel_major else summed))

    def fold(self, summed):
        """Per-channel sums back to canonical residues (< m_i); raw buffer
        or ``RnsArray`` (returned in kind)."""
        summed, proto = self._split(summed)
        m = torch.tensor(tuple(self.base.moduli) + self.redundant,
                         dtype=summed.dtype, device=summed.device)
        return self._rejoin(torch.remainder(summed, m), proto)

    def decode(self, folded):
        """Folded packed tensor (raw or ``RnsArray``) -> f32 values (exact
        up to the f32 cast)."""
        folded, _ = self._split(folded)
        v = rns_to_tensor(self.base, folded[..., : self.base.n])
        half = (self.base.M + 1) // 2
        v = torch.where(v >= half, v - self.base.M, v)
        return (v.to(torch.float64) * 2.0 ** -self.frac_bits).to(torch.float32)

    # ------------------------------------------- Algorithm-1 ring queries
    def _alg1_view(self, folded):
        """The (..., n+1) slice Algorithm-1 queries consume: base residues
        plus m_a (m_b, when present, takes no part in comparisons)."""
        folded, _ = self._split(folded)
        return folded[..., : self.base.n + 1]

    def is_negative(self, folded):
        """Sign test without reconstruction: one Alg.-1 comparison.

        Needs a CONSISTENT m_a channel: fresh encodings have one; a sum of
        W > 1 replicas needs ``normalize`` first."""
        return is_negative(self.base, self._alg1_view(folded))

    def abs_ge(self, folded, thr: int):
        """|value| >= thr (in quantized units): two Alg.-1 comparisons.
        Same consistency requirement as ``is_negative``."""
        return abs_ge_threshold(self.base, self._alg1_view(folded), int(thr))

    def normalize(self, folded):
        """Rebuild consistent redundant channels from the base residues (one
        MRC + one Alg.-3 dot per redundant channel).  Identity on fresh
        encodings; after a W-replica sum it re-anchors m_a (and m_b) to the
        wrapped value so Alg.-1 queries apply to the sum.

        It overwrites the redundant channels, so it forfeits their
        detection power: run ``verify_packed`` / ``correct_packed`` first."""
        folded, proto = self._split(folded)
        x = folded[..., : self.base.n]
        digits = mrc_unrolled(self.base, x)
        xr = mrs_dot_mod(self.base, digits, self.redundant)
        return self._rejoin(torch.cat([x, xr.to(x.dtype)], dim=-1), proto)

    def verify_packed(self, folded):
        """Redundant-channel consistency check (transit corruption detector).

        After summing W replicas ``carried - recomputed`` must equal
        ``k * (M mod m_r)`` mod m_r for a wrap count k <= world; any other
        offset means a corrupted channel.  With m_b both channels must give
        the SAME k.  Discriminating power requires ``world < m_a``."""
        folded, _ = self._split(folded)
        x = folded[..., : self.base.n]
        digits = mrc_unrolled(self.base, x)
        recomputed = mrs_dot_mod(self.base, digits, self.redundant)

        def wrap_count(carried, rec, mr: int):
            delta = torch.remainder(
                carried.to(torch.int64) - rec.to(torch.int64), mr
            )
            # gcd(M, m_r) = 1: k = delta * (M mod m_r)^{-1} mod m_r
            inv = pow(self.base.M % mr, -1, mr)
            return torch.remainder(delta * inv, mr)

        ka = wrap_count(folded[..., self.base.n], recomputed[..., 0],
                        self.base.ma)
        ok = ka <= min(self.world, self.base.ma - 1)
        if self.mb is not None:
            kb = wrap_count(folded[..., self.base.n + 1],
                            recomputed[..., 1], self.mb)
            ok = ok & (kb <= min(self.world, self.mb - 1)) & (ka == kb)
        return ok

    # ------------------------------------------- RRNS locate-and-correct
    def repair_columns_(self, rows, *, wraps: int = 0,
                        verdict: bool = False):
        """Locate-and-correct the (n_channels, B) codewords ``rows`` in
        place (a view of any strides, in the base's lane dtype): one call of
        ``kernels.ops.rrns_repair_op``, the repair kernel on the card and
        its plain version elsewhere, the same bits.  Returns ``(counts,
        verdict)``: the int64 ``[repaired, unrepairable, scanned]`` on
        ``rows``' device and, with ``verdict=True``, ``locate_fault``'s (B,)
        verdicts.  Under a profiler the span ``rrns.scan``."""
        from ..kernels.ops import rrns_repair_op

        with span("rrns.scan"):
            return rrns_repair_op(self, rows, wraps=wraps, verdict=verdict)

    def locate_fault(self, folded, *, wraps: int = 0):
        """Locate a single corrupted channel per element: int32 over
        ``folded``'s batch shape holding the channel index, ``-1`` for a
        clean codeword, ``-2`` for an uncorrectable one.

        ``wraps`` bounds the legitimate range at (wraps+1)*M: 0 for fresh
        encodings and normalized sums, ``world - 1`` for a raw post-psum
        buffer.  Location is exact at wraps=0; at wraps>0 an ambiguous
        corruption reports -2 rather than ever miscorrecting.

        >>> import torch
        >>> rrns = GradCodec.make(world=2, correct=True)
        >>> buf = rrns.encode(torch.tensor([3.0, -2.0]))
        >>> bad = buf.clone(); bad[0, 1] = (bad[0, 1] + 5) % rrns.base.moduli[1]
        >>> rrns.locate_fault(bad).tolist()      # elt 1 stays clean
        [1, -1]
        """
        return self.correct_packed(folded, wraps=wraps)[1]

    def correct_packed(self, folded, *, wraps: int = 0):
        """Locate-and-correct: ``(corrected, fault)``, where ``fault`` is
        ``locate_fault``'s verdict and ``corrected`` has each single-fault
        element's bad channel rebuilt from the survivors (clean and
        uncorrectable elements pass through untouched).  One
        ``repair_columns_`` call on an (n_channels, B) copy in the base's
        lane dtype; ``corrected`` comes back in ``folded``'s layout, type
        and dtype.

        >>> import torch
        >>> rrns = GradCodec.make(world=2, correct=True)
        >>> buf = rrns.encode(torch.tensor([3.0, -2.0]))
        >>> bad = buf.clone(); bad[0, 1] = (bad[0, 1] + 5) % rrns.base.moduli[1]
        >>> fixed, fault = rrns.correct_packed(bad)
        >>> bool(torch.equal(fixed, buf))
        True
        """
        folded, proto = self._split(folded)
        rows = folded.reshape(-1, self.n_channels).T.to(self.base.tdtype,
                                                        copy=True)
        _, fault = self.repair_columns_(rows, wraps=wraps, verdict=True)
        fixed = rows.T.reshape(folded.shape).to(folded.dtype)
        return (self._rejoin(fixed, proto),
                fault.reshape(folded.shape[:-1]))

    def range_ok(self, p1, p2):
        """Packed-ge usable as an overflow guard: (p1 >= p2) per Alg. 1."""
        return compare_packed_ge(
            self.base, self._alg1_view(p1), self._alg1_view(p2)
        )


def _all_reduce(buf, group):
    """In-place per-channel int32 SUM over ``group`` — the ONE collective."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


def rns_psum(codec: GradCodec, g, group=None):
    """Exact mean-gradient all-reduce of one tensor over ``group``:
    encode -> per-channel int32 all-reduce -> fold -> decode -> / size."""
    summed = _all_reduce(codec.encode_packed(g).contiguous(), group)
    return codec.decode_summed(summed) / float(dist.get_world_size(group))


# ------------------------------------------------------ bucketed transport
@dataclasses.dataclass(frozen=True)
class _TreeMeta:
    """Layout of the single wire buffer: the tree and each leaf's shape and
    dtype, in leaf order."""

    treedef: object
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(math.prod(s) for s in self.shapes)


def tree_pack(codec: GradCodec, grads, *, out=None):
    """Flatten a gradient tree (leaf order as the reference's) into ONE
    contiguous channel-major ``(n_channels, B_total)`` int32 wire buffer
    (``out`` when given).  Returns ``(buf, meta)``; ``meta`` is what
    ``tree_decode`` needs."""
    leaves, treedef = _tree.flatten(grads)
    if not leaves:
        raise ValueError("tree_pack: empty gradient pytree")
    meta = _TreeMeta(
        treedef=treedef,
        shapes=tuple(tuple(l.shape) for l in leaves),
        dtypes=tuple(l.dtype for l in leaves),
    )
    flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    return codec.encode_packed(flat, channel_major=True, out=out), meta


def tree_pack_rns(codec: GradCodec, grads, *, out=None):
    """``tree_pack`` with a typed wire buffer: the whole gradient tree as
    ONE channel-major ``RnsArray`` (layout BASE_MA/RRNS per the codec)."""
    buf, meta = tree_pack(codec, grads, out=out)
    return codec.as_array(buf, channel_major=True), meta


def tree_decode(codec: GradCodec, summed, meta: _TreeMeta, denom=1.0):
    """Channel-major per-channel sums (raw or ``RnsArray``) -> gradient tree
    / ``denom``; each leaf is a view of one flat decoded buffer, cast to the
    leaf's own dtype.  Under a profiler the span ``codec.decode``."""
    with span("codec.decode"):
        flat = codec.decode_summed(summed, channel_major=True).div_(denom)
        leaves, off = [], 0
        for shape, dtype, size in zip(meta.shapes, meta.dtypes, meta.sizes):
            leaves.append(flat[off : off + size].reshape(shape).to(dtype))
            off += size
        return _tree.unflatten(meta.treedef, leaves)


def rns_psum_tree(codec: GradCodec, grads, group=None):
    """Exact mean-gradient all-reduce of a WHOLE tree in one collective:
    ``tree_pack_rns`` -> one int32 all-reduce of the channel-major buffer
    -> decode -> unflatten."""
    arr, meta = tree_pack_rns(codec, grads)
    _all_reduce(arr.residues, group)
    return tree_decode(codec, arr, meta,
                       denom=float(dist.get_world_size(group)))
