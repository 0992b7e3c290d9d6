"""Batched Mixed-Radix Conversion (paper Alg. 2): the CUDA kernel
``csrc/mrc.cu`` and its plain torch version, and what the two column
kernels (``csrc/mrc.cu``, ``csrc/rns_compare.cu``) share on the host: the
format of a base's table image and the launch geometry.

Counterpart of ``src/repro/kernels/mrc.py::mrc_kernel_call``.  The plain
version takes channel-major (n, B) int32 residues, the (n, n) table
``inv[j, i] = m_j^{-1} mod m_i`` and the (n,) moduli, and returns (n, B)
digits.  The kernel call keeps the (n, B) signature but takes any (n, B)
view: it reads the operand where it lies, through its strides, so the
transposed view of channels-last rows (the port's arrays) costs no copy;
it takes the tables as one byte image (``column_image``; ``ops`` caches it
per base).  The kernel holds a column's channels in registers, a warp
a column (a thread a column for n <= 16); see ``csrc/mrc_warp.cuh`` and
``csrc/columns.cuh``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .common import mrc_rows

__all__ = ["mrc_kernel_call", "mrc_plain", "column_layout", "column_image",
           "column_mapping", "launch_geometry", "check_image", "MAX_CHANNELS",
           "WARPS", "BLOCKS_PER_SM"]

# Channels a column kernel takes: 32 lanes times 14 register slots
# (csrc/columns.cuh, kColMaxChannels).
MAX_CHANNELS = 448
# Warps a block (csrc/columns.cuh, kColMaxWarps); fewer only where the
# batch has fewer columns.
WARPS = 8
# Blocks a column kernel launches an SM, at most (launch_geometry): as many
# blocks of WARPS warps as an SM's 2,048 threads take.  On the H100 this
# cap was within 2.2 % of the best of 1, 2, 3, 4, 6, 8 and none at the
# paper's and the quickstart's widths; no cap lost 21 % on the n = 8
# compare (tools/column_grid.py).
BLOCKS_PER_SM = 8
# Widest base of the thread mapping (csrc/columns.cuh, kColNarrow).
NARROW = 16
LAYOUT_FIELDS = ("n", "betas", "tri", "image")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def column_mapping(n: int) -> int:
    """Lanes a column for n channels: 1 (a thread a column, the column in
    its registers) for n <= 16, 32 (a warp a column) above
    (csrc/columns.cuh's instances)."""
    return 1 if n <= NARROW else 32


@functools.lru_cache(maxsize=None)
def column_layout(n: int) -> dict:
    """Byte offsets of the table image for n channels, the one definition
    of its format (the kernels get them as an argument): moduli int32 at 0,
    betas int32 at ``betas``, the triangle's uint16 entries at ``tri`` (16
    aligned, at least 64 bytes on: the spare lanes of the triangle's step
    read up to 64 bytes before it), ``image`` bytes in all (a multiple of
    16: the block stages it 16 bytes a copy).  Cached: read, never change."""
    tri = _up(max(8 * n, 64), 16)
    return dict(n=n, betas=4 * n, tri=tri, image=_up(tri + n * (n - 1), 16))


@functools.lru_cache(maxsize=None)
def _layout_arg(n: int):
    L = column_layout(n)
    return (ctypes.c_int * len(LAYOUT_FIELDS))(*(L[f] for f in LAYOUT_FIELDS))


def column_image(moduli, betas, inv) -> np.ndarray:
    """A base's tables as the column kernels' uint8 image
    (``column_layout``): the (n,) moduli and the (n,) betas
    prod_{k<i} m_k mod m_a as int32, and the triangle's entries inv[j, i]
    for i > j as uint16, row j after row j - 1 (entry
    ``j (2n - j - 1) / 2 + i - j - 1``)."""
    inv = np.asarray(inv, np.int64)
    n = inv.shape[0]
    L = column_layout(n)
    img = np.zeros(L["image"], np.uint8)
    for off, arr, dt in ((0, moduli, np.int32), (L["betas"], betas, np.int32),
                         (L["tri"], inv[np.triu_indices(n, k=1)], np.uint16)):
        b = np.ascontiguousarray(np.asarray(arr, dt)).view(np.uint8).reshape(-1)
        img[off : off + b.size] = b
    return img


def check_image(what: str, image, n: int, device) -> None:
    """Raise unless ``image`` is the 16-byte aligned uint8 image of an
    n-channel base on ``device`` and n is one the kernels take."""
    if not 1 <= n <= MAX_CHANNELS:
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_CHANNELS} "
                         f"channels, got n={n}")
    want = column_layout(n)["image"]
    if image.dtype != torch.uint8 or image.shape != (want,):
        raise ValueError(f"{what}: the table image must be {want} uint8 "
                         f"bytes for n={n}, got {image.dtype} "
                         f"{tuple(image.shape)}")
    if image.device != device or image.data_ptr() % 16:
        raise ValueError(f"{what}: the table image must be 16-byte aligned "
                         f"on the operands' device ({device})")


def launch_geometry(n: int, B: int, device) -> tuple:
    """(lanes a column, warps a block, blocks) of a column kernel on B
    columns: WARPS warps a block, or fewer where B needs fewer; at most
    BLOCKS_PER_SM blocks an SM, each walking its columns in a grid-stride
    loop and staging the tables once."""
    lanes = column_mapping(n)
    warps_needed = -(-B // (32 // lanes))
    warps = min(WARPS, warps_needed)
    blocks = -(-warps_needed // warps)
    return lanes, warps, min(blocks, BLOCKS_PER_SM * build.sm_count(device))


def mrc_plain(x_t, inv, m):
    """The kernel's function in plain torch (any device)."""
    return mrc_rows(x_t, inv, m)


def mrc_kernel_call(x_t, image):
    """Launch ``csrc/mrc.cu`` on PyTorch's current stream (no sync).

    ``x_t``: an (n, B) int32 view on the card, any strides; ``image``: the
    base's ``column_image`` on the same card.  Returns the (n, B) digits,
    stored where the kernel's stores coalesce: channel-major for the thread
    mapping (n <= 16), the transposed view of channels-last (B, n) rows for
    the warp mapping."""
    n, B = x_t.shape
    dev = x_t.device
    args = build.operands("mrc", x_t)
    check_image("mrc", image, n, dev)
    if column_mapping(n) == 1:
        out = torch.empty((n, B), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((B, n), dtype=torch.int32, device=dev).T
    if B == 0:
        return out
    geometry = launch_geometry(n, B, dev)
    with build.device_guard(dev):
        err = build.load().rns_mrc(*args, *build.view_args(out),
                                   image.data_ptr(), _layout_arg(n),
                                   *geometry, B, build.stream(dev))
    build.check(err, "mrc")
    return out
