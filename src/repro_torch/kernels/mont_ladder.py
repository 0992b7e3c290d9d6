"""Dual-base Montgomery product and fused ladder bit: the CUDA kernels
``csrc/mont_ladder.cu`` and their plain torch versions.

Counterparts of ``src/repro/kernels/mont_ladder.py::mont_mul_kernel_call``
and ``::mont_ladder_kernel_call``.  One Montgomery product MM(X, Y) on a
column chains every RNS primitive of the package (core/montgomery.py
documents the algebra):

    q      = x·y·(-N^{-1})    channel-wise in B       Barrett products
    digits = MRC(q)           Alg. 2 triangle          (mrc_rows)
    q'     = digits · betas   Alg. 3 dot -> B'         (_dot_rows)
    r'     = (x'y' + q'N)·M^{-1}  channel-wise in B'
    r      = extend(r')       MRC + dot back to B (+ redundant channels)

The ladder kernel fuses ONE exponent bit — two products and the branchless
select.  Per-request moduli ``N`` arrive as data (``neg``/``nhi`` per
column), so one launch serves a batch of different moduli.

Operands are channel-major int32: ``lo`` (nch_lo, B), ``hi`` (n_hi, B),
``neg`` (n, B), ``nhi`` (n_hi, B), ``bit`` (B,).  The plain versions take
the seven tables in this orientation (``ops._mont_tables`` builds them):

    inv_lo (n, n)        inv_lo[j, i] = m_j^{-1} mod m_i
    m_lo (nch_lo,)       B-side channel moduli, base then redundant
    bl2h (n, n_hi)       bl2h[j, t] = prod_{k<j} m_k mod m'_t
    inv_hi (n_hi, n_hi)  the same triangle over B'
    m_hi (n_hi,)         B' moduli
    bh2l (n_hi, nch_lo)  bh2l[j, t] = prod_{k<j} m'_k mod m_t
    minv (n_hi,)         M^{-1} mod m'_j

The kernels take the same tables as one byte ``image`` (``pack_image``;
``ops._mont_image`` caches it per base pair), laid out as a block's shared
memory holds them (``smem_layout``; this module owns that format, and the
launch passes its offsets to the kernels, ``block_layout``): the moduli and their multiply-high
reciprocals floor(2**32 / m), M^{-1}, both triangles' upper halves as
16-bit words, and both beta tables transposed to one row per target and
split into a low and a high byte plane for the tensor cores' u8 products.
``dot_limbs`` is the plain version of that dot: four limb products summed
exactly, then one exact reduction — equal to ``_dot_rows`` bit for bit.

Inputs < 2N per column keep every output < 2N, every intermediate product
inside the exact Barrett range, and both extensions exact.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .common import barrett_mod, mod_mulhi, mrc_rows, recip

__all__ = ["mont_mul_kernel_call", "mont_ladder_kernel_call",
           "mont_mul_plain", "mont_ladder_plain", "smem_layout",
           "block_layout", "block_cols", "pack_image", "dot_limbs",
           "LAYOUT_FIELDS", "MAX_CHANNELS"]

# Channels a side the kernels take: 32 lanes times the register slots a
# lane holds (csrc/mont_ladder.cu, kSlots).
MAX_CHANNELS = 160
# Shared memory a block may take on sm_90 (csrc/common.cuh, kMaxSmem); the
# launch refuses shapes whose 16-column block would need more.
MAX_SMEM = 232448
# The fields of csrc/mont_ladder.cu's ``Layout``, in its order: the kernels
# take ``block_layout``'s numbers as they are and compute no offset.
LAYOUT_FIELDS = ("n", "nch_lo", "n_hi", "nt1", "nt2", "k1", "k2", "s1", "s2",
                 "sd", "rs", "m_lo", "mu_lo", "m_hi", "mu_hi", "minv",
                 "tri_lo", "tri_hi", "b1", "b2", "image", "dig", "res",
                 "io_rows", "cols", "io", "smem")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def smem_layout(n: int, nch_lo: int, n_hi: int) -> dict:
    """Byte offsets of the table image and of a block's scratch, the one
    definition of the format (the kernels get them through
    ``block_layout``): dot targets padded to 8 (``nt1`` = n_hi, ``nt2`` =
    nch_lo), depths to 32 (``k1`` = n, ``k2`` = n_hi), table rows of
    ``k + 16`` bytes.  ``image`` is the image's size; ``smem_bytes`` the
    shared memory of a block.  Cached: callers read it, never change it."""
    L = dict(n=n, nch_lo=nch_lo, n_hi=n_hi, nt1=_up(n_hi, 8),
             nt2=_up(nch_lo, 8), k1=_up(n, 32), k2=_up(n_hi, 32))
    L.update(s1=L["k1"] + 16, s2=L["k2"] + 16,
             sd=max(L["k1"], L["k2"]) + 16, rs=max(L["nt1"], L["nt2"]) + 4)
    L["m_lo"] = 0
    L["mu_lo"] = L["m_lo"] + 4 * L["nt2"]
    L["m_hi"] = L["mu_lo"] + 4 * L["nt2"]
    L["mu_hi"] = L["m_hi"] + 4 * L["nt1"]
    L["minv"] = L["mu_hi"] + 4 * L["nt1"]
    L["tri_lo"] = L["minv"] + 4 * L["nt1"]
    L["tri_hi"] = L["tri_lo"] + _up(n * (n - 1), 16)
    L["b1"] = L["tri_hi"] + _up(n_hi * (n_hi - 1), 16)
    L["b2"] = L["b1"] + 2 * L["nt1"] * L["s1"]
    L["image"] = L["b2"] + 2 * L["nt2"] * L["s2"]
    L["dig"] = L["image"]
    L["res"] = L["dig"] + 2 * 16 * L["sd"]
    L["io_rows"] = max(nch_lo, n_hi)
    return L


@functools.lru_cache(maxsize=None)
def block_layout(n: int, nch_lo: int, n_hi: int, cols: int) -> dict:
    """``smem_layout`` for a ``cols``-column block: adds ``cols``, the
    output tile's offset ``io`` (after the residue tile) and ``smem``, the
    block's dynamic shared memory — the image, the digit planes, the
    residue tile and the output tile.  Cached: read it, never change it."""
    L = dict(smem_layout(n, nch_lo, n_hi), cols=cols)
    L["io"] = L["res"] + 4 * cols * L["rs"]
    L["smem"] = L["io"] + 4 * L["io_rows"] * (cols + 1)
    return L


def smem_bytes(n: int, nch_lo: int, n_hi: int, cols: int) -> int:
    """Dynamic shared memory of a ``cols``-column block of the kernels."""
    return block_layout(n, nch_lo, n_hi, cols)["smem"]


def block_cols(B: int, device: torch.device) -> int:
    """The block's columns on ``device``: 16 where 16-column blocks still
    give every SM one (B >= 16 x SMs), else 8."""
    return 16 if -(-B // 16) >= build.sm_count(device) else 8


@functools.lru_cache(maxsize=None)
def _layout_arg(n: int, nch_lo: int, n_hi: int, cols: int):
    """``block_layout`` as the C entry points take it: int32 fields in
    ``LAYOUT_FIELDS`` order."""
    L = block_layout(n, nch_lo, n_hi, cols)
    return (ctypes.c_int * len(LAYOUT_FIELDS))(*(L[f] for f in LAYOUT_FIELDS))


def _words(v, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v, dtype)).view(np.uint8)


def pack_image(inv_lo, m_lo, bl2h, inv_hi, m_hi, bh2l, minv) -> np.ndarray:
    """The seven tables (numpy, in the plain versions' orientation) as the
    kernels' uint8 shared-memory image (``smem_layout``):

    * ``m_lo``/``m_hi`` int32 and ``mu`` = floor(2**32 / m) uint32, padded
      to the dot's target width with m = 1 (mu 0; those results are never
      read); ``minv`` padded with 0;
    * each triangle's entries inv[j, i] for i > j as uint16, row j after
      row j - 1 (entry ``j (2n - j - 1) / 2 + i - j - 1``);
    * each beta table transposed to ``[t, j]`` (target-major, the digit
      index along the row), zero-padded, split into a low-byte plane
      (beta & 255) and a high-byte plane (beta >> 8).
    """
    n, n_hi, nch_lo = inv_lo.shape[0], inv_hi.shape[0], m_lo.shape[0]
    L = smem_layout(n, nch_lo, n_hi)
    img = np.zeros(L["image"], np.uint8)

    def put(off, arr):
        b = arr.reshape(-1)
        img[off : off + b.size] = b

    for side, m, nt in (("lo", m_lo, L["nt2"]), ("hi", m_hi, L["nt1"])):
        mp = np.ones(nt, np.int64)
        mp[: m.shape[0]] = m
        put(L["m_" + side], _words(mp, np.int32))
        put(L["mu_" + side], _words(((1 << 32) // mp) & 0xFFFFFFFF,
                                    np.uint32))
    put(L["minv"], _words(minv, np.int32))
    for key, inv in (("tri_lo", inv_lo), ("tri_hi", inv_hi)):
        iu = np.triu_indices(inv.shape[0], k=1)    # row-major: (j, i), i > j
        put(L[key], _words(np.asarray(inv)[iu], np.uint16))
    for key, betas, nt, st in (("b1", bl2h, L["nt1"], L["s1"]),
                               ("b2", bh2l, L["nt2"], L["s2"])):
        bt = np.asarray(betas, np.int64).T         # (targets, digits)
        for plane, part in enumerate((bt & 0xFF, bt >> 8)):
            rows = np.zeros((nt, st), np.uint8)
            rows[: bt.shape[0], : bt.shape[1]] = part
            put(L[key] + plane * nt * st, rows)
    return img


def dot_limbs(digits, lo_plane, hi_plane, m):
    """The kernels' tensor-core dot in plain torch: (n, B) digits d < 2**15
    against byte planes (T, n) of the betas -> (T, B) residues.

    d = 256 dh + dl and beta = 256 bh + bl; the four limb products are
    summed exactly (each sum < n * 2**16 < 2**24 for n <= 160, as the
    kernel's s32 accumulators hold it), then S mod m = (((hh mod m) * 256 +
    lh + hl) mod m * 256 + ll) mod m by the multiply-high step — the
    canonical residue, equal to ``_dot_rows``.
    """
    d = digits.to(torch.int64)
    dl, dh = d & 0xFF, d >> 8
    bl, bh = lo_plane.to(torch.int64), hi_plane.to(torch.int64)
    ll, lh, hl, hh = bl @ dl, bh @ dl, bl @ dh, bh @ dh
    mc = m.to(torch.int32)[:, None]
    v = mod_mulhi(hh.to(torch.int32), mc).to(torch.int64)
    v = mod_mulhi((v * 256 + lh + hl).to(torch.int32), mc).to(torch.int64)
    return mod_mulhi((v * 256 + ll).to(torch.int32), mc)


def _dot_rows(digits, betas, m):
    """Alg. 3 dot against T targets on an (n, B) digit tile -> (T, B).

    betas: (n, T) with betas[j, t] = prod_{k<j} m_k mod m_t;  m: (T,).
    Each term is Barrett-reduced and the running sum kept < m by one
    conditional subtract, as the kernel and the reference's ``_dot_rows``
    do.
    """
    m_col = m[:, None]
    r_col = recip(m_col)
    acc = torch.zeros((m.shape[0], digits.shape[1]), dtype=torch.int32,
                      device=digits.device)
    for j in range(digits.shape[0]):
        s = acc + barrett_mod(digits[j] * betas[j][:, None], m_col, r_col)
        acc = torch.where(s >= m_col, s - m_col, s)
    return acc


def _mm_tile(xlo, xhi, ylo, yhi, neg, nhi, inv_lo, m_lo, bl2h, inv_hi,
             m_hi, bh2l, minv):
    """One Montgomery product on (rows, B) tiles; returns (lo, hi)."""
    n = inv_lo.shape[0]
    mlo, mhi = m_lo[:, None], m_hi[:, None]
    rlo, rhi = recip(mlo), recip(mhi)
    mb, rb = mlo[:n], rlo[:n]
    q = barrett_mod(barrett_mod(xlo[:n] * ylo[:n], mb, rb) * neg, mb, rb)
    qp = _dot_rows(mrc_rows(q, inv_lo, m_lo[:n]), bl2h, m_hi)     # (n_hi, B)
    t = barrett_mod(xhi * yhi, mhi, rhi) + barrett_mod(qp * nhi, mhi, rhi)
    t = torch.where(t >= mhi, t - mhi, t)
    r_hi = barrett_mod(t * minv[:, None], mhi, rhi)
    r_lo = _dot_rows(mrc_rows(r_hi, inv_hi, m_hi), bh2l, m_lo)    # (nch_lo, B)
    return r_lo, r_hi


def mont_mul_plain(xlo, xhi, ylo, yhi, neg, nhi, *tables):
    """The product kernel's function in plain torch (any device)."""
    return _mm_tile(xlo, xhi, ylo, yhi, neg, nhi, *tables)


def mont_ladder_plain(r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, *tables):
    """The ladder kernel's function in plain torch (any device): both
    products always run and the select is a data-independent ``where``."""
    keep = (bit == 0)[None, :]
    t_lo, t_hi = _mm_tile(r0lo, r0hi, r1lo, r1hi, neg, nhi, *tables)
    sq_lo = torch.where(keep, r0lo, r1lo)
    sq_hi = torch.where(keep, r0hi, r1hi)
    s_lo, s_hi = _mm_tile(sq_lo, sq_hi, sq_lo, sq_hi, neg, nhi, *tables)
    return (torch.where(keep, s_lo, t_lo), torch.where(keep, s_hi, t_hi),
            torch.where(keep, t_lo, s_lo), torch.where(keep, t_hi, s_hi))


def _shapes(what, lo, hi, neg, nhi, image):
    """(n, nch_lo, n_hi, B) after checking every operand's shape and the
    image's size against the shapes."""
    nch_lo, B = lo.shape
    n_hi, n = hi.shape[0], neg.shape[0]
    if (hi.shape != (n_hi, B) or neg.shape != (n, B) or nhi.shape != (n_hi, B)
            or n > nch_lo or n < 1):
        raise ValueError(f"{what}: operand shapes do not fit (n={n}, "
                         f"nch_lo={nch_lo}, n_hi={n_hi}, B={B})")
    if max(nch_lo, n_hi) > MAX_CHANNELS:
        raise ValueError(f"{what}: the kernel takes at most {MAX_CHANNELS} "
                         f"channels a side, got nch_lo={nch_lo}, n_hi={n_hi}")
    want = smem_layout(n, nch_lo, n_hi)["image"]
    if image.dtype != torch.uint8 or image.shape != (want,):
        raise ValueError(f"{what}: the table image must be {want} uint8 "
                         f"bytes for these shapes, got {image.dtype} "
                         f"{tuple(image.shape)}")
    if image.device != lo.device or image.data_ptr() % 16:
        raise ValueError(f"{what}: the table image must be 16-byte aligned "
                         f"on the operands' device ({lo.device})")
    return n, nch_lo, n_hi, B


def mont_mul_kernel_call(xlo, xhi, ylo, yhi, neg, nhi, image):
    """Launch ``rns_mont_mul`` on PyTorch's current stream (no sync);
    ``image`` from ``pack_image``.  Returns ``(olo (nch_lo, B), ohi (n_hi,
    B))``."""
    n, nch_lo, n_hi, B = _shapes("mont_mul", xlo, xhi, neg, nhi, image)
    if ylo.shape != xlo.shape or yhi.shape != xhi.shape:
        raise ValueError("mont_mul: x and y tiles differ in shape")
    olo, ohi = torch.empty_like(xlo), torch.empty_like(xhi)
    ptrs = build.pointers("mont_mul", xlo, xhi, ylo, yhi, neg, nhi, olo, ohi)
    img = build.pointers("mont_mul", image, dtype=torch.uint8)[0]
    layout = _layout_arg(n, nch_lo, n_hi, block_cols(B, xlo.device))
    with build.device_guard(xlo.device):
        err = build.load().rns_mont_mul(*ptrs, img, layout, B,
                                        build.stream(xlo.device))
    build.check(err, "mont_mul")
    return olo, ohi


def mont_ladder_kernel_call(r0lo, r0hi, r1lo, r1hi, bit, neg, nhi, image):
    """Launch ``rns_mont_ladder`` on PyTorch's current stream (no sync);
    ``bit: (B,)`` int32, ``image`` from ``pack_image``.  Returns ``(o0lo,
    o0hi, o1lo, o1hi)``."""
    n, nch_lo, n_hi, B = _shapes("mont_ladder", r0lo, r0hi, neg, nhi, image)
    if (r1lo.shape != r0lo.shape or r1hi.shape != r0hi.shape
            or bit.shape != (B,)):
        raise ValueError("mont_ladder: r0, r1 and bit shapes do not fit")
    outs = [torch.empty_like(t) for t in (r0lo, r0hi, r0lo, r0hi)]
    ptrs = build.pointers("mont_ladder", r0lo, r0hi, r1lo, r1hi, bit, neg,
                          nhi, *outs)
    img = build.pointers("mont_ladder", image, dtype=torch.uint8)[0]
    layout = _layout_arg(n, nch_lo, n_hi, block_cols(B, r0lo.device))
    with build.device_guard(r0lo.device):
        err = build.load().rns_mont_ladder(*ptrs, img, layout, B,
                                           build.stream(r0lo.device))
    build.check(err, "mont_ladder")
    return tuple(outs)
