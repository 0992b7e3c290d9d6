"""Public wrappers for the RNS kernels: ``mrc_op``, ``modmul_op``,
``compare_op``, the gradient codec's ``codec_encode_op``,
``codec_decode_op`` and ``rrns_repair_op``, the dual-base Montgomery
``mont_mul_op`` and ``mont_ladder_op``, and the SSD core of the Mamba2
models, ``ssd_op`` (f32, differentiable: ``kernels/ssd.py``).

They present the same channels-last ``(..., n)`` API as ``repro_torch.core``
and handle:

* layout: flatten the batch to the kernels' (n, B) int32 operands and
  back, with the output cast to the input dtype.  ``mrc_op`` and
  ``compare_op`` hand the column kernels (n, B) *views* of int32 operands,
  which they read where they lie (channels-last rows and the divmod's
  packed rows included: no copy); the other kernels take contiguous
  channel-major tiles (no copy when the operand is already channel-major,
  e.g. an ``RnsArray`` with ``channel_axis=0``);
* the device: a CUDA tensor launches the kernel — there is no fallback — and
  a CPU tensor takes the kernel's plain torch version;
* constraints: the kernels need 15-bit (int32-lane) bases; wider bases
  raise here (``repro_torch.core`` serves them); the codec kernels also
  need M < 2**45 (three 15-bit limbs), as the reference's do.  On the
  CPU the RRNS repair's plain version takes any base (the codec's
  locate-and-correct runs through it); on the card its kernel's limits
  raise;
* ``RnsArray`` operands in place of the ``base, x[, xa]`` argument group.
  ``modmul_op`` on such operands reduces ALL channels, redundant rows
  included, each in its own modulus, and returns an ``RnsArray``.

Each wrapper counts its kernel launches in ``<op>.launches``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.array import RnsArray
from ..core.base import RNSBase
from . import build
from .codec_decode import codec_decode_kernel_call, codec_decode_plain
from .codec_encode import codec_encode_kernel_call, codec_encode_plain
from .modmul import modmul_kernel_call, modmul_plain
from .mont_ladder import (mont_ladder_kernel_call, mont_ladder_plain,
                          mont_mul_kernel_call, mont_mul_plain, pack_image)
from .mrc import column_image, mrc_kernel_call, mrc_plain
from .rns_compare import compare_kernel_call, compare_plain
from .rrns_repair import (repair_image, rrns_repair_kernel_call,
                          rrns_repair_plain)
from .ssd import SSDFunction, check_operands, dense, ssd_plain

__all__ = ["mrc_op", "modmul_op", "compare_op", "codec_encode_op",
           "codec_decode_op", "rrns_repair_op", "mont_mul_op",
           "mont_ladder_op", "mont_ladder_steps_op", "ssd_op", "reset_launches"]


def _on_card(t) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain); a
    DTensor raises (``build.refuse_dtensor``)."""
    build.refuse_dtensor("RNS kernels", t)
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"RNS kernels run on CUDA or CPU tensors, not {t.device}")


def _check_bits(base: RNSBase):
    if base.bits > 15:
        raise ValueError("the RNS kernels require bits<=15 (int32 lanes); "
                         "use repro_torch.core for wider bases")


def _tiles(x, nch: int):
    """(..., nch) -> contiguous (nch, B) int32 tile, plus the batch shape."""
    return x.reshape(-1, nch).T.contiguous().to(torch.int32), x.shape[:-1]


def _untile(out_t, lead, nch: int, dtype):
    return out_t.T.reshape(*lead, nch).to(dtype)


def _rows(x, nch: int):
    """(..., nch) -> an (nch, B) int32 view of ``x``'s storage where the
    batch flattens to one stride (int32 ``x``), else of a copy.  Each step
    is skipped where it would change nothing: a divmod makes thousands of
    one-column calls, and the host's time is theirs."""
    if x.dim() != 2:
        x = x.reshape(-1, nch)
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x.T


def _flat(xa, lead):
    """(...,) m_a residues broadcast to ``lead`` -> a (B,) int32 view."""
    if xa.shape != lead:
        xa = xa.expand(lead)
    if xa.dim() != 1:
        xa = xa.reshape(-1)
    return xa if xa.dtype == torch.int32 else xa.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _column_image(base: RNSBase, device: torch.device):
    """The column kernels' table image of ``base`` (``mrc.column_image``)
    as a uint8 tensor on ``device``, uploaded once."""
    img = column_image(base.moduli_np, base.betas_ma_np, base.inv_tri_np)
    return torch.from_numpy(img).to(device)


def mrc_op(base, x=None):
    """Mixed-radix digits of ``x: (..., n)`` via the MRC kernel.

    Also callable as ``mrc_op(arr)`` with an ``RnsArray`` — digits of the
    base channels, channels-last.
    """
    if isinstance(base, RnsArray):
        base, x = base.base, base.x
    _check_bits(base)
    xt = _rows(x, base.n)
    if _on_card(x):
        out = mrc_kernel_call(xt, _column_image(base, x.device))
        mrc_op.launches += int(xt.shape[1] > 0)
    else:
        out = mrc_plain(xt, base.tensor("inv_tri_np", x.device, torch.int32),
                        base.tensor("moduli_np", x.device, torch.int32))
    return _untile(out, x.shape[:-1], base.n, x.dtype)


def modmul_op(base, x=None, y=None):
    """Channel-wise (x * y) mod m_i via the modmul kernel.

    Also callable as ``modmul_op(a, b)`` with two ``RnsArray`` operands of
    matching base/layout: every channel then reduces in its own modulus
    (redundant rows included) and the result comes back typed.
    """
    arr = None
    if isinstance(base, RnsArray):
        arr, other = base, x
        if not isinstance(other, RnsArray):
            raise TypeError("modmul_op(a, b) needs both operands as RnsArray")
        other = arr._lift(other)  # validates matching base/layout/mb
        base = arr.base
        x, y = arr.to_packed(), other.to_packed()
        table = ("moduli_with", arr.redundant_moduli)
    else:
        table = "moduli_np"
    _check_bits(base)
    if x.shape != y.shape:
        raise ValueError(f"modmul_op: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ")
    m = base.tensor(table, x.device, torch.int32)
    nch = m.numel()
    xt, lead = _tiles(x, nch)
    yt, _ = _tiles(y, nch)
    if _on_card(x):
        out = modmul_kernel_call(xt, yt, m)
        modmul_op.launches += 1
    else:
        out = modmul_plain(xt, yt, m)
    out = _untile(out, lead, nch, x.dtype)
    if arr is None:
        return out
    return RnsArray(
        out, base, layout=arr.layout, signed=arr.signed or other.signed,
        channel_axis=-1, mb=arr.mb,
    ).with_channel_axis(arr.channel_axis)


def compare_op(base, x1=None, xa1=None, x2=None, xa2=None):
    """Fused Algorithm 1: boolean (N1 >= N2) for batched operands.

    x1, x2: (..., n); xa1, xa2: (...,).  Also callable as
    ``compare_op(a, b)`` with two ``RnsArray`` operands (BASE_MA or RRNS
    layout — the m_a channel drives Theorem 1).
    """
    if isinstance(base, RnsArray):
        a, b = base, x1
        if not isinstance(b, RnsArray):
            raise TypeError("compare_op(a, b) needs both operands as RnsArray")
        b = a._lift(b)  # validates matching base/layout/mb
        base, x1, xa1, x2, xa2 = a.base, a.x, a.xa, b.x, b.xa
    _check_bits(base)
    dev = x1.device
    lead = x1.shape[:-1]
    x1t = _rows(x1, base.n)
    x2t = _rows(x2 if x2.shape == x1.shape else x2.expand(x1.shape), base.n)
    a1, a2 = _flat(xa1, lead), _flat(xa2, lead)
    if _on_card(x1):
        out = compare_kernel_call(x1t, a1, x2t, a2, _column_image(base, dev),
                                  base.ma)
        compare_op.launches += int(x1t.shape[1] > 0)
        return out.reshape(lead)
    out = compare_plain(x1t, a1, x2t, a2,
                        base.tensor("inv_tri_np", dev, torch.int32),
                        base.tensor("moduli_np", dev, torch.int32),
                        base.tensor("betas_ma_np", dev, torch.int32), base.ma)
    return out.reshape(lead).to(torch.bool)


# ------------------------------------------------------ gradient codec
def _check_codec(codec, what: str):
    if codec.base.M >= 1 << 45:
        raise ValueError(f"codec {what} kernel requires M < 2**45 (3 limbs)")
    _check_bits(codec.base)


@functools.lru_cache(maxsize=None)
def _encode_tables(base: RNSBase, redundant: tuple[int, ...]):
    """Host tables of the encode: moduli (base, then redundant), 2**15 mod
    each, and the negative-embedding shift (0 on base rows, M mod m_r)."""
    m = tuple(base.moduli) + tuple(redundant)
    pow15 = tuple((1 << 15) % mi for mi in m)
    off = (0,) * base.n + tuple(base.M % r for r in redundant)
    return m, pow15, off


@functools.lru_cache(maxsize=None)
def _decode_tables(base: RNSBase):
    """Host tables of the decode: moduli, the MRC inverse table, and the
    15-bit limbs of T = ceil(M/2) and of M."""
    T, M = (base.M + 1) // 2, base.M
    half = tuple(v >> s & 0x7FFF for v in (T, M) for s in (0, 15, 30))
    return tuple(base.moduli), np.asarray(base.inv_tri_np, np.int64), half


def codec_encode_op(codec, g, *, channel_major: bool = False, out=None):
    """Gradient-codec encode: f32 tensor (...,) -> int32 residues
    (..., nch), bitwise equal to ``GradCodec.encode``; nch counts the base
    channels and the codec's redundant ones (m_a, and m_b on a
    locate-and-correct codec).

    ``channel_major=True`` returns the kernels' (nch, B) layout of the
    flattened input, the wire format of the bucketed transport, written
    into ``out`` when given.
    """
    _check_codec(codec, "encode")
    if out is not None and not channel_major:
        raise ValueError("codec_encode: out= takes the channel-major layout")
    m, pow15, off = _encode_tables(codec.base, codec.redundant)
    row = g.reshape(-1).to(torch.float32).contiguous()
    kw = dict(scale=float(1 << codec.frac_bits), qh=codec.qmax >> 15,
              ql=codec.qmax & 0x7FFF)
    if _on_card(g):
        out = codec_encode_kernel_call(row, m, pow15, off, out=out, **kw)
        codec_encode_op.launches += int(row.numel() > 0)
    elif out is not None:
        out.copy_(codec_encode_plain(row, m, pow15, off, **kw))
    else:
        out = codec_encode_plain(row, m, pow15, off, **kw)
    if channel_major:
        return out
    return out.T.reshape(*g.shape, len(m))


def codec_decode_op(codec, summed, *, channel_major: bool = False):
    """Gradient-codec decode: per-channel sums (..., nch) -> f32 values
    (...,), the decoded value times 2**-frac_bits (the caller divides by
    the replica count).  Only the base channels are read.

    ``channel_major=True`` takes the kernels' (nch, B) layout directly and
    returns (B,) — no transpose on the bucketed transport's path.
    """
    _check_codec(codec, "decode")
    m, inv, half = _decode_tables(codec.base)
    if channel_major:
        x, lead = summed.to(torch.int32).contiguous(), None
    else:
        x, lead = _tiles(summed, summed.shape[-1])
    inv_scale = 2.0 ** -codec.frac_bits
    if _on_card(summed):
        out = codec_decode_kernel_call(x, m, inv, half, inv_scale=inv_scale)
        codec_decode_op.launches += int(x.shape[1] > 0)
    else:
        out = codec_decode_plain(x, m, inv, half, inv_scale=inv_scale)
    return out if channel_major else out.reshape(lead)


@functools.lru_cache(maxsize=None)
def _repair_image(base: RNSBase, redundant: tuple[int, ...], wraps: int,
                  device: torch.device):
    """The repair's table image (``rrns_repair.repair_image``) of a codec's
    base and redundant pair at ``wraps`` as a uint8 tensor on ``device``,
    uploaded once."""
    return torch.from_numpy(repair_image(base, redundant, wraps)).to(device)


def rrns_repair_op(codec, x, *, wraps: int = 0, verdict: bool = False):
    """RRNS locate-and-correct of the (n_channels, B) codewords ``x`` (a
    view of any strides, fixed in place) of a locate-and-correct codec:
    each column with a single faulted channel gets its residue rebuilt.
    Returns the int64 counts ``[repaired, unrepairable, scanned]``
    (``scanned``: the columns that failed the clean test) on ``x``'s
    device, and with ``verdict=True`` the (B,) int32 verdicts (-1 clean,
    the faulted channel, -2 unrepairable); nothing waits for the host.

    A CPU tensor takes the plain version, of any base, in the base's lane
    dtype.  On the card the kernel runs: int32 codewords of 15-bit moduli
    and 1 to ``rrns_repair.MAX_BASE`` base channels, or it raises.  Both
    give the same bits.
    """
    if codec.mb is None:
        raise ValueError("rrns_repair_op needs a locate-and-correct codec: "
                         "GradCodec.make(correct=True)")
    if not _on_card(x):
        return rrns_repair_plain(codec, x, wraps=wraps, verdict=verdict)
    _check_bits(codec.base)
    image = _repair_image(codec.base, codec.redundant, int(wraps), x.device)
    counts, out = rrns_repair_kernel_call(x, image, verdict=verdict)
    rrns_repair_op.launches += int(x.shape[1] > 0)
    return counts, out


# ------------------------------------------------- Montgomery (dual-base)
@functools.lru_cache(maxsize=None)
def _mont_tables_np(baseB: RNSBase, baseBp: RNSBase,
                    lo_targets: tuple[int, ...]):
    """Host tables of the dual-base Montgomery kernels, in their
    orientation (kernels/mont_ladder.py), cached per base pair and B-side
    channel layout (N-independent)."""
    from ..core.montgomery import minv_residues

    for b in (baseB, baseBp):
        _check_bits(b)
    hi_t = tuple(int(m) for m in baseBp.moduli)
    return (
        np.asarray(baseB.inv_tri_np, np.int32),                 # (n, n)
        np.asarray(lo_targets, np.int32),                       # (nch_lo,)
        np.asarray(baseB.betas_for(hi_t), np.int32).T,          # (n, n')
        np.asarray(baseBp.inv_tri_np, np.int32),                # (n', n')
        np.asarray(hi_t, np.int32),                             # (n',)
        np.asarray(baseBp.betas_for(lo_targets), np.int32).T,   # (n', nch_lo)
        np.asarray(minv_residues(baseB, hi_t), np.int32),       # (n',)
    )


@functools.lru_cache(maxsize=None)
def _mont_tables(baseB: RNSBase, baseBp: RNSBase,
                 lo_targets: tuple[int, ...], device: torch.device):
    """``_mont_tables_np`` as contiguous int32 tensors on ``device``,
    uploaded once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in _mont_tables_np(baseB, baseBp, lo_targets))


@functools.lru_cache(maxsize=None)
def _mont_image(baseB: RNSBase, baseBp: RNSBase,
                lo_targets: tuple[int, ...], device: torch.device):
    """The kernels' shared-memory image of ``_mont_tables_np``
    (``mont_ladder.pack_image``) as a uint8 tensor on ``device``, uploaded
    once."""
    img = pack_image(*_mont_tables_np(baseB, baseBp, lo_targets))
    return torch.from_numpy(img).to(device)


def _mont_prep(d, lead):
    """DualRep -> channel-major (nch_lo, B) and (n_hi, B) int32 tiles of
    its value broadcast to the batch shape ``lead``."""
    lo = d.lo._cl().expand(*lead, d.lo.n_channels)
    hi = d.hi._cl().expand(*lead, d.hi.base.n)
    return _tiles(lo, d.lo.n_channels)[0], _tiles(hi, d.hi.base.n)[0]


def _mont_consts_prep(x, neg, n_hi, lead):
    """The per-``N`` rows broadcast to ``lead`` as (n, B) / (n_hi, B) tiles."""
    neg = neg.expand(*lead, x.lo.base.n)
    n_hi = n_hi.expand(*lead, x.hi.base.n)
    return _tiles(neg, x.lo.base.n)[0], _tiles(n_hi, x.hi.base.n)[0]


def _mont_wrap(x, out_lo, out_hi, lead):
    from ..core.montgomery import DualRep

    lo = _untile(out_lo, lead, out_lo.shape[0], x.lo.dtype)
    hi = _untile(out_hi, lead, out_hi.shape[0], x.hi.dtype)
    return DualRep(x.lo._wrap(lo, signed=False), x.hi._wrap(hi, signed=False))


def _mont_setup(x, operands, neg, n_hi):
    """Tables (the kernels' image on the card, the seven tables of the plain
    versions on the CPU), the per-``N`` rows as tensors on ``x``'s device,
    and the broadcast batch shape of ``operands`` (DualReps or bit tensors)
    and the rows — one call can mix moduli N across columns."""
    _check_bits(x.lo.base)
    _check_bits(x.hi.base)
    dev = x.lo.device
    lo_targets = tuple(int(m) for m in x.lo.channel_moduli)
    make = _mont_image if dev.type == "cuda" else _mont_tables
    tables = make(x.lo.base, x.hi.base, lo_targets, dev)
    neg = torch.as_tensor(neg, device=dev)
    n_hi = torch.as_tensor(n_hi, device=dev)
    shapes = [o.lo.shape if hasattr(o, "lo") else o.shape for o in operands]
    # numpy's broadcast rule: torch.broadcast_shapes imports torch's _refs
    # package on its first call, seconds of host time
    lead = np.broadcast_shapes(*shapes, neg.shape[:-1], n_hi.shape[:-1])
    return tables, neg, n_hi, tuple(lead)


def mont_mul_op(x, y, neg, n_hi):
    """Batched Montgomery product MM(X, Y) via the product kernel.

    ``x``/``y`` are ``DualRep`` operands (core/montgomery.py); ``neg`` /
    ``n_hi`` are the per-``N`` channel rows from ``mont_consts`` — data,
    not constants, broadcast against the batch.  Bitwise-identical to the
    plain ``_mont_mul_torch``.
    """
    tables, neg, n_hi, lead = _mont_setup(x, (x, y), neg, n_hi)
    xlo, xhi = _mont_prep(x, lead)
    ylo, yhi = _mont_prep(y, lead)
    neg_t, nhi_t = _mont_consts_prep(x, neg, n_hi, lead)
    if _on_card(xlo):
        out_lo, out_hi = mont_mul_kernel_call(xlo, xhi, ylo, yhi, neg_t,
                                              nhi_t, tables)
        mont_mul_op.launches += 1
    else:
        out_lo, out_hi = mont_mul_plain(xlo, xhi, ylo, yhi, neg_t, nhi_t,
                                        *tables)
    return _mont_wrap(x, out_lo, out_hi, lead)


def mont_ladder_op(r0, r1, bit, neg, n_hi):
    """One Montgomery-ladder bit — two products and the branchless select
    — in a single kernel launch.  Returns the updated ``(r0, r1)`` pair."""
    bit = torch.as_tensor(bit, device=r0.lo.device)
    return mont_ladder_steps_op(r0, r1, bit[..., None], neg, n_hi)


def mont_ladder_steps_op(r0, r1, bits, neg, n_hi):
    """``bits.shape[-1]`` Montgomery-ladder bits in a row, ``bits: (...,
    k)`` with the batch shape leading: ``k`` ladder-kernel launches, one a
    bit (counted on ``mont_ladder_op.launches``), with the operands kept in
    the kernels' channel-major tiles between them — the tables, transposes
    and per-``N`` rows are prepared once.  Bitwise equal to ``k`` calls of
    ``mont_ladder_op``; returns the final ``(r0, r1)``."""
    bits = torch.as_tensor(bits, device=r0.lo.device)
    tables, neg, n_hi, lead = _mont_setup(r0, (r0, r1, bits[..., 0]), neg,
                                          n_hi)
    r0lo, r0hi = _mont_prep(r0, lead)
    r1lo, r1hi = _mont_prep(r1, lead)
    neg_t, nhi_t = _mont_consts_prep(r0, neg, n_hi, lead)
    k = bits.shape[-1]
    bit_t = bits.expand(*lead, k).reshape(-1, k).T.to(torch.int32).contiguous()
    on_card = _on_card(r0lo)
    for i in range(k):
        args = (r0lo, r0hi, r1lo, r1hi, bit_t[i], neg_t, nhi_t)
        if on_card:
            r0lo, r0hi, r1lo, r1hi = mont_ladder_kernel_call(*args, tables)
            mont_ladder_op.launches += 1
        else:
            r0lo, r0hi, r1lo, r1hi = mont_ladder_plain(*args, *tables)
    return (_mont_wrap(r0, r0lo, r0hi, lead),
            _mont_wrap(r0, r1lo, r1hi, lead))


# ------------------------------------------------------------ SSD core
def ssd_op(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked SSD scan, ``models/ssm.py::ssd``'s contract: (y (b, s,
    h, p) without the D skip, the final state (b, h, ds, p)), with its
    gradients.  A CUDA tensor runs the kernels (``kernels/ssd.py``; f32
    operands, or it raises), 4 launches forward and 6 backward, counted
    here; a CPU tensor the plain version, ``kernels/ssd.py::ssd_plain``."""
    if not _on_card(x):
        return ssd_plain(x, dt, A, B, C, chunk, initial_state)
    if B.dim() == 3:                      # one group, without its axis
        B, C = B[:, :, None], C[:, :, None]
    check_operands(x, dt, A, B, C, chunk, initial_state)
    return SSDFunction.apply(*(dense(t) for t in (x, dt, A, B, C)),
                             dense(initial_state), int(chunk), _count_ssd)


def _count_ssd(n: int) -> None:
    ssd_op.launches += n


def reset_launches() -> dict:
    """Zero every wrapper's launch count; returns the counts it cleared."""
    counts = {}
    for op in (mrc_op, modmul_op, compare_op, codec_encode_op,
               codec_decode_op, rrns_repair_op, mont_mul_op, mont_ladder_op,
               ssd_op):
        counts[op.__name__] = op.launches
        op.launches = 0
    return counts


mrc_op.launches = 0
modmul_op.launches = 0
compare_op.launches = 0
codec_encode_op.launches = 0
codec_decode_op.launches = 0
rrns_repair_op.launches = 0
mont_mul_op.launches = 0
mont_ladder_op.launches = 0
ssd_op.launches = 0
