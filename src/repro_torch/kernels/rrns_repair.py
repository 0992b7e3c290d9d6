"""The RRNS repair in one pass over the codewords: the CUDA kernel
``csrc/rrns_repair.cu`` and its plain torch version, ``rrns_repair_plain``.

The reference package has no kernel for it: its ``GradCodec._fault_scan``
is plain jnp.  Here that scan is ``survivor_scan`` (the survivor bases and
R's digits: ``survivor_tables``), and both versions run it only where a
column fails a clean test, with the same bits.

A column of n base residues and the redundant pair (m_a, m_b) is *clean*
when its base residues are canonical (x_i < m_i) and their value X < M,
extended to m_a and m_b (Alg. 2, then Alg. 3), gives the carried pair.
Then all n + 2 residues are those of one X < M, so every survivor base
(all channels but one) reconstructs X, which is below R = (wraps + 1) M:
``survivor_scan`` finds every channel consistent and gives the verdict
-1, whatever ``wraps``.  A clean column is left as it is.  Every other
column takes the scan; on a unique hit the faulted channel's residue is
rebuilt in place.  The kernel does that scan in its own registers, with
the same int32 operations as ``mrc_unrolled``, ``mrs_ge`` and
``mrs_dot_mod``, which the plain version calls.

Both versions take an (nch, B) view of the codewords (any strides; nch =
n + 2), fix it in place, and return the int64 counts ``[repaired,
unrepairable, scanned]`` (verdict >= 0, verdict == -2, clean test failed)
and, with ``verdict=True``, the (B,) int32 verdicts.  The kernel takes
int32 codewords of 1 to MAX_BASE base channels of 15-bit moduli and reads
the codec's tables from one image (``repair_image``; ``ops`` caches it per
codec and ``wraps``); the plain version any base, in its lane dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.base import RNSBase
from ..core.convert import mrs_dot_mod
from ..core.mrc import mrc_unrolled, mrs_ge
from . import build
from .mrc import launch_geometry

__all__ = ["rrns_repair_kernel_call", "rrns_repair_plain", "survivor_scan",
           "survivor_tables", "repair_layout", "repair_image", "MAX_BASE",
           "LAYOUT_FIELDS", "REPAIR_COLUMNS"]

# Widest base the kernel takes (csrc/rrns_repair.cu, kMaxBase): every base
# of 15-bit moduli with M < 2**45, which the codec kernels take.
MAX_BASE = 3
# Columns one pass of the plain version holds at once: its temporaries are
# a few times this many residues a channel (about 1.3 GB at 2**24 on a
# five-channel codec), where one pass over a 10**9-column wire would need
# several times the wire itself.
REPAIR_COLUMNS = 1 << 24
LAYOUT_FIELDS = ("n", "mod", "mu", "beta", "smod", "sinv", "sbeta", "rdig",
                 "tri", "image")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=None)
def survivor_tables(moduli: tuple, redundant: tuple, bits: int, wraps: int):
    """Per-channel tables for RRNS fault location.

    For each channel c of the base + redundant set: the survivor base
    (every modulus but m_c, with m_c as its Alg.-3 target) and the
    mixed-radix digits of the legitimate bound R = (wraps+1)*M in it.  A
    reconstruction without c lands below R iff c is consistent with the
    survivors.
    """
    chans = tuple(moduli) + tuple(redundant)
    R = (wraps + 1) * math.prod(moduli)
    tables = []
    for c, mc in enumerate(chans):
        surv = tuple(m for i, m in enumerate(chans) if i != c)
        if R >= math.prod(surv):
            raise ValueError(
                f"RRNS locate: legitimate range (wraps+1)*M = {R} does not "
                f"fit the survivor product of channel {c}; lower wraps "
                f"(usually world-1) or widen the redundant moduli"
            )
        sb = RNSBase(moduli=surv, ma=mc, bits=bits)
        digits, x = [], R
        for m in surv:
            digits.append(x % m)
            x //= m
        tables.append((sb, tuple(digits)))
    return tuple(tables)


def _tables(codec, wraps: int):
    """``survivor_tables`` of a locate-and-correct codec at ``wraps``."""
    base = codec.base
    return survivor_tables(base.moduli, codec.redundant, base.bits,
                           int(wraps))


@functools.lru_cache(maxsize=None)
def repair_layout(n: int) -> dict:
    """Byte offsets of the table image of an n-channel base (nch = n + 2
    channels, s = n + 1 survivors), the one definition of its format (the
    kernel gets them as an argument).  int32 words: ``mod`` the nch moduli
    (base, m_a, m_b); ``mu`` floor(2**32 / m) of m_a and m_b; ``beta`` the
    base's betas into m_a, then into m_b (2 x n); per channel c, in channel
    order: ``smod`` its survivors' moduli (nch x s), ``sinv`` their table
    inv[j, k] = m_j^{-1} mod m_k, 0 for k <= j (nch x s x s), ``sbeta``
    their betas into m_c (nch x s), ``rdig`` R's mixed-radix digits in
    them (nch x s); then ``tri``, the base's triangle as uint16 in
    ``mrc_thread``'s order; ``image`` bytes in all, a multiple of 16.
    Cached: read, never change."""
    nch, s = n + 2, n + 1
    words = {"mod": nch, "mu": 2, "beta": 2 * n, "smod": nch * s,
             "sinv": nch * s * s, "sbeta": nch * s, "rdig": nch * s}
    out, off = {"n": n}, 0
    for k, w in words.items():
        out[k], off = off, off + 4 * w
    out["tri"] = off
    out["image"] = _up(off + n * (n - 1), 16)
    return out


@functools.lru_cache(maxsize=None)
def _layout_arg(n: int):
    L = repair_layout(n)
    return (ctypes.c_int * len(LAYOUT_FIELDS))(*(L[f] for f in LAYOUT_FIELDS))


def repair_image(base, redundant, wraps: int) -> np.ndarray:
    """The repair's tables as a uint8 image (``repair_layout``).

    ``base`` is the codec's ``RNSBase``, ``redundant`` its (m_a, m_b);
    the survivor tables are ``survivor_tables``' at ``wraps``: per channel
    its survivor ``RNSBase`` (target m_c) and R's digits."""
    n = base.n
    if len(redundant) != 2:
        raise ValueError("repair_image: a locate-and-correct codec has two "
                         "redundant moduli")
    survivors = survivor_tables(base.moduli, tuple(redundant), base.bits,
                                int(wraps))
    L = repair_layout(n)
    mod = tuple(base.moduli) + tuple(redundant)
    parts = {
        "mod": (mod, np.int32),
        "mu": ([(1 << 32) // m for m in redundant], np.uint32),
        "beta": (base.betas_for(redundant), np.int32),
        "smod": ([sb.moduli for sb, _ in survivors], np.int32),
        "sinv": ([sb.inv_tri_np for sb, _ in survivors], np.int32),
        "sbeta": ([sb.betas_for((sb.ma,))[0] for sb, _ in survivors],
                  np.int32),
        "rdig": ([d for _, d in survivors], np.int32),
        "tri": (np.asarray(base.inv_tri_np, np.int64)[np.triu_indices(n, 1)],
                np.uint16),
    }
    img = np.zeros(L["image"], np.uint8)
    for k, (arr, dt) in parts.items():
        b = np.ascontiguousarray(np.asarray(arr, np.int64).astype(dt))
        b = b.view(np.uint8).reshape(-1)
        img[L[k] : L[k] + b.size] = b
    return img


def _check(what: str, x_t, dtype=torch.int32, nch: int | None = None) -> int:
    """n for an (n + 2, B) operand of ``dtype``, or raise: of the codec's
    ``nch`` channels when given (the plain version), else of 1 to MAX_BASE
    base channels (the kernel)."""
    if x_t.dim() != 2 or x_t.dtype != dtype:
        raise ValueError(f"{what}: the codewords must be an (nch, B) {dtype} "
                         f"view, got {x_t.dtype} {tuple(x_t.shape)}")
    n = x_t.shape[0] - 2
    if nch is not None and x_t.shape[0] != nch:
        raise ValueError(f"{what}: the codec has {nch - 2} base channels and "
                         f"two redundant ones, got {x_t.shape[0]} channels")
    if nch is None and not 1 <= n <= MAX_BASE:
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_BASE} base "
                         f"channels and two redundant ones, got "
                         f"{x_t.shape[0]} channels")
    return n


def survivor_scan(codec, x_t, wraps: int = 0):
    """The survivor scan of every column of the (nch, B) codewords ``x_t``
    of a locate-and-correct ``codec``: ``(verdict, fixes)``.  For each
    channel c an MRC over the surviving channels, a mixed-radix compare
    against R = (wraps+1)*M and the Alg.-3 extension back to m_c.  The
    (B,) int32 verdict is -1 where every channel is consistent, the channel
    on a unique hit, -2 otherwise; ``fixes`` (nch, B) holds each channel's
    rebuilt residue, in ``x_t``'s dtype."""
    chans = tuple(codec.base.moduli) + codec.redundant
    cols = x_t.T
    oks, fixes = [], []
    for c, (sb, r_digits) in enumerate(_tables(codec, wraps)):
        d = mrc_unrolled(sb, torch.cat([cols[:, :c], cols[:, c + 1:]], dim=1))
        bound = torch.tensor(r_digits, dtype=d.dtype,
                             device=d.device).expand(d.shape)
        oks.append(~mrs_ge(d, bound))  # reconstruction-sans-c < R
        fixes.append(mrs_dot_mod(sb, d, (chans[c],))[:, 0])
    ok = torch.stack(oks)
    cnt = ok.sum(dim=0)
    hit = torch.argmax(ok.to(torch.int32), dim=0).to(torch.int32)
    verdict = torch.where(cnt == len(chans), -1,
                          torch.where(cnt == 1, hit, -2)).to(torch.int32)
    return verdict, torch.stack(fixes)


def _repair_pass(codec, x_t, wraps: int):
    """One pass of ``rrns_repair_plain`` over the (nch, b) columns ``x_t``,
    fixed in place: ``(counts, the failing columns, their verdicts)``."""
    base, n = codec.base, codec.base.n
    m = base.tensor("moduli_np", x_t.device, x_t.dtype)
    cols = x_t.T
    canon = ((cols[:, :n] >= 0) & (cols[:, :n] < m)).all(dim=1)
    digits = mrc_unrolled(base, torch.where(canon[:, None], cols[:, :n], 0))
    ext = mrs_dot_mod(base, digits, codec.redundant)
    clean = canon & (ext == cols[:, n:]).all(dim=1)
    at = torch.nonzero(~clean)[:, 0]
    v, fixes = survivor_scan(codec, x_t[:, at], wraps)
    hit = torch.nonzero(v >= 0)[:, 0]
    rows = v[hit].to(torch.int64)
    x_t[rows, at[hit]] = fixes[rows, hit]
    counts = torch.stack([torch.tensor(hit.numel(), device=x_t.device),
                          (v == -2).sum(),
                          torch.tensor(at.numel(), device=x_t.device)])
    return counts, at, v


def rrns_repair_plain(codec, x_t, *, wraps: int = 0, verdict: bool = False):
    """The kernel's function in plain torch (any device, any base), for
    the locate-and-correct ``codec``, on codewords in its base's lane dtype:
    the clean test on every column, then ``survivor_scan`` on the columns
    that fail it, each unique hit's rebuilt residue written in place;
    REPAIR_COLUMNS columns a pass (each column is its own codeword, so the
    passes give the bits of one pass over the whole buffer)."""
    _check("rrns_repair", x_t, codec.base.tdtype, codec.n_channels)
    _tables(codec, wraps)               # a wraps R does not fit raises here
    dev, B = x_t.device, x_t.shape[1]
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    out = (torch.full((B,), -1, dtype=torch.int32, device=dev) if verdict
           else None)
    for a in range(0, B, REPAIR_COLUMNS):
        part = x_t[:, a : a + REPAIR_COLUMNS]
        c, at, v = _repair_pass(codec, part, wraps)
        counts += c
        if out is not None:
            out[a + at] = v
    return counts, out


def rrns_repair_kernel_call(x_t, image, *, verdict: bool = False):
    """Launch ``csrc/rrns_repair.cu`` on PyTorch's current stream (no
    sync): ``x_t`` an (nch, B) int32 view on the card (any strides), fixed
    in place; ``image`` the codec's ``repair_image`` on the same card."""
    n = _check("rrns_repair", x_t)
    want = repair_layout(n)["image"]
    if image.dtype != torch.uint8 or image.shape != (want,):
        raise ValueError(f"rrns_repair: the table image must be {want} uint8 "
                         f"bytes for n={n}, got {image.dtype} "
                         f"{tuple(image.shape)}")
    dev = x_t.device
    args = build.operands("rrns_repair", x_t)
    if image.device != dev or image.data_ptr() % 16:
        raise ValueError("rrns_repair: the table image must be 16-byte "
                         f"aligned on the operands' device ({dev})")
    B = x_t.shape[1]
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    out = (torch.empty(B, dtype=torch.int32, device=dev) if verdict
           else None)
    if B == 0:
        return counts, out
    _, warps, blocks = launch_geometry(n, B, dev)
    with build.device_guard(dev):
        err = build.load().rns_rrns_repair(
            *args, None if out is None else out.data_ptr(),
            counts.data_ptr(), image.data_ptr(), _layout_arg(n), warps,
            blocks, B, build.stream(dev))
    build.check(err, "rrns_repair")
    return counts, out
