"""The RRNS repair in one pass over the codewords: the CUDA kernel
``csrc/rrns_repair.cu`` and its plain torch version.

The reference package has no kernel for it: its ``GradCodec._fault_scan``
is plain jnp, and so is the port's.  The kernel replaces the port's chain
``_fault_scan`` -> ``_verdict`` -> ``where`` on the card, with the same
bits.

A column of n base residues and the redundant pair (m_a, m_b) is *clean*
when its base residues are canonical (x_i < m_i) and their value X < M,
extended to m_a and m_b (Alg. 2, then Alg. 3), gives the carried pair.
Then all n + 2 residues are those of one X < M, so every survivor base
(all channels but one) reconstructs X, which is below R = (wraps + 1) M:
``_fault_scan`` finds every channel consistent and ``_verdict`` gives -1,
whatever ``wraps``.  A clean column is left as it is.  Every other column
takes ``_fault_scan``'s five-survivor scan, then ``_verdict``; on a unique
hit the faulted channel's residue is rebuilt in place.  The kernel does
that scan in its own registers, with the same int32 operations as
``mrc_unrolled``, ``mrs_ge`` and ``mrs_dot_mod``; the plain version calls
the codec's ``_fault_scan`` and ``_verdict`` on the columns that fail the
clean test.

Both versions take an (nch, B) int32 view of the codewords (any strides;
nch = n + 2), fix it in place, and return the int64 counts
``[repaired, unrepairable, scanned]`` (verdict >= 0, verdict == -2, clean
test failed) and, with ``verdict=True``, the (B,) int32 verdicts.  The
kernel reads the codec's tables from one image (``repair_image``; ``ops``
caches it per codec and ``wraps``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .mrc import launch_geometry

__all__ = ["rrns_repair_kernel_call", "rrns_repair_plain", "repair_layout",
           "repair_image", "MAX_BASE", "LAYOUT_FIELDS"]

# Widest base the kernel takes (csrc/rrns_repair.cu, kMaxBase): every base
# of 15-bit moduli with M < 2**45, which the codec kernels take.
MAX_BASE = 3
LAYOUT_FIELDS = ("n", "mod", "mu", "beta", "smod", "sinv", "sbeta", "rdig",
                 "tri", "image")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


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


def repair_image(base, redundant, survivors) -> np.ndarray:
    """The repair's tables as a uint8 image (``repair_layout``).

    ``base`` is the codec's ``RNSBase``, ``redundant`` its (m_a, m_b),
    ``survivors`` ``grad_codec._survivor_tables``'s output for one
    ``wraps``: per channel its survivor ``RNSBase`` (target m_c) and R's
    digits."""
    n = base.n
    if len(redundant) != 2 or len(survivors) != n + 2:
        raise ValueError("repair_image: a locate-and-correct codec has two "
                         "redundant moduli and a survivor base a channel")
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


def _check(what: str, x_t, nch: int | None = None) -> int:
    """n for an (n + 2, B) int32 operand, or raise: of the codec's ``nch``
    channels when given (the plain version), else of 1 to MAX_BASE base
    channels (the kernel)."""
    if x_t.dim() != 2 or x_t.dtype != torch.int32:
        raise ValueError(f"{what}: the codewords must be an (nch, B) int32 "
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


def rrns_repair_plain(codec, x_t, *, wraps: int = 0, verdict: bool = False):
    """The kernel's function in plain torch (any device), for the
    locate-and-correct ``codec``: the clean test on every column, then the
    codec's own ``_fault_scan`` and ``_verdict`` on the columns that fail
    it, each unique hit's rebuilt residue written in place."""
    n = _check("rrns_repair", x_t, codec.n_channels)
    dev = x_t.device
    folded = x_t.T
    m = codec.base.tensor("moduli_np", dev, x_t.dtype)
    canon = ((folded[:, :n] >= 0) & (folded[:, :n] < m)).all(dim=1)
    ext = codec.normalize(torch.where(canon[:, None], folded, 0))[:, n:]
    clean = canon & (ext == folded[:, n:]).all(dim=1)
    cols = torch.nonzero(~clean)[:, 0]
    ok, fixes = codec._fault_scan(folded[cols], wraps)
    v = codec._verdict(ok)
    hit = torch.nonzero(v >= 0)[:, 0]
    rows = v[hit].to(torch.int64)
    x_t[rows, cols[hit]] = fixes[hit, rows].to(x_t.dtype)
    counts = torch.stack([torch.tensor(hit.numel(), device=dev),
                          (v == -2).sum(),
                          torch.tensor(cols.numel(), device=dev)])
    if not verdict:
        return counts.to(torch.int64), None
    out = torch.full((x_t.shape[1],), -1, dtype=torch.int32, device=dev)
    out[cols] = v
    return counts.to(torch.int64), out


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
