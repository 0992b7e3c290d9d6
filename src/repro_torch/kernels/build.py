"""Build and load the CUDA kernels: ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use into ``kernels/_build/`` (listed in
``.gitignore``).  Its file name carries a hash of every source and of the
flags, so a stale library is never loaded.  Each ``.cu`` compiles in its own
``nvcc`` process, all started together, and one link makes the library.
A missing ``nvcc`` or a failed build raises; nothing falls back.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

__all__ = ["build", "load", "check", "pointers", "view_args", "operands",
           "stream", "device_guard", "sm_count"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = ("mrc.cu", "modmul.cu", "rns_compare.cu", "codec_encode.cu",
            "codec_decode.cu", "mont_ladder.cu", "rrns_repair.cu", "ssd.cu")
# sm_90a (Hopper); IEEE division and no FMA contraction of the Barrett
# product are the defaults — never add --use_fast_math (see common.cuh).
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # x and its (n, B) strides, out and its strides, table image, host
    # layout (mrc.column_layout), lanes a column, warps, blocks, B, stream
    "rns_mrc": [_P, _L, _L, _P, _L, _L, _P, _P, _I, _I, _L, _L, _P],
    # x1 and strides, xa1 and stride, the same for x2 and xa2, out (bool),
    # table image, host layout, m_a, lanes, warps, blocks, B, stream
    "rns_compare": [_P, _L, _L, _P, _L, _P, _L, _L, _P, _L, _P, _P, _P, _I,
                    _I, _I, _L, _L, _P],
    # name: (x..., out, tables..., ints..., B, stream)
    "rns_modmul": [_P, _P, _P, _P, _I, _L, _P],
    # g, out, host m / pow15 / off, nch, scale, qh, ql, B, stream
    "rns_codec_encode": [_P, _P, _P, _P, _P, _I, _F, _I, _I, _L, _P],
    # x, out, host m / inv / half, n, inv_scale, B, stream
    "rns_codec_decode": [_P, _P, _P, _P, _P, _I, _F, _L, _P],
    # x lo/hi, y lo/hi, neg, nhi, out lo/hi, table image, host layout
    # (mont_ladder.block_layout), B, stream
    "rns_mont_mul": [_P] * 10 + [_L, _P],
    # r0 lo/hi, r1 lo/hi, bit, neg, nhi, 4 outs, table image, host layout,
    # B, stream
    "rns_mont_ladder": [_P] * 13 + [_L, _P],
    # x and its (nch, B) strides, verdict (or NULL), counts (int64), table
    # image, host layout (rrns_repair.repair_layout), warps, blocks, B,
    # stream
    "rns_rrns_repair": [_P, _L, _L, _P, _P, _P, _P, _I, _L, _L, _P],
    # x, dt, A, B, C, initial state (or NULL), y, final state, cum, S, CB,
    # yoff (or NULL), b, s, h, p, G, ds, Q, stream
    "ssd_forward": [_P] * 12 + [_I] * 7 + [_P],
    # x, dt, A, B, C, dy, dfinal (or NULL), cum, S, CB, yoff, the scratch
    # dS, dCB, rowpart, colpart, off, dw, dtpart, dApart, then dx, ddt, dB,
    # dC, dinit (or NULL), b, s, h, p, G, ds, Q, stream
    "ssd_backward": [_P] * 24 + [_I] * 7 + [_P],
}


def _nvcc() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``, the toolkit's install location)."""
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels if their library is not built yet.

    Returns ``{"path", "seconds", "built", "ptxas"}``: ``ptxas`` maps each
    source to the ``-Xptxas -v`` lines (registers, shared memory, spills)
    of a fresh build, and is empty when the library was already there.
    """
    lib = _BUILD / f"librns_kernels_{_digest()}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "built": False, "ptxas": {}}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        procs = {}
        for src in _SOURCES:
            obj = os.path.join(tmp, src + ".o")
            cmd = [nvcc, *_ARCH, *_FLAGS, "-c", str(_CSRC / src), "-o", obj]
            procs[src] = (obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = {}, []
        for src, (_, proc) in procs.items():
            out, _ = proc.communicate()
            logs[src] = out
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[s] for s in failed))
        part = os.path.join(tmp, lib.name)
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", part,
             *(obj for obj, _ in procs.values())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(part, lib)  # atomic: a concurrent build never sees half a file
    ptxas = {s: [ln.strip() for ln in log.splitlines()
                 if "ptxas" in ln or "spill" in ln]
             for s, log in logs.items()}
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "built": True, "ptxas": ptxas}


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with typed entry points."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def refuse_dtensor(what: str, t) -> None:
    """A kernel reads raw device memory: a DTensor's storage is not its
    global tensor, so its local shard (``to_local()``) must be passed."""
    if isinstance(t, DTensor):
        raise TypeError(f"{what}: got a DTensor; the kernels take plain "
                        "tensors, pass its local shard (t.to_local())")


def pointers(what: str, *tensors, dtype=torch.int32) -> list[int]:
    """Device pointers of a kernel's operands, after checking that they are
    contiguous tensors of ``dtype`` on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        refuse_dtensor(what, t)
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous {dtype}, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
    return [t.data_ptr() for t in tensors]


def view_args(t) -> list[int]:
    """``t``'s address and its element strides, as the column kernels take
    an operand that they read where it lies (no copy)."""
    refuse_dtensor("view_args", t)
    return [t.data_ptr(), *t.stride()]


def operands(what: str, *tensors, dtype=torch.int32) -> list[int]:
    """``view_args`` of each operand, flattened, after checking that they
    are ``dtype`` tensors on one CUDA device (any strides)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{what}: operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: operands must be {dtype}, got "
                             f"{t.dtype}")
    return [a for t in tensors for a in view_args(t)]


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SM count of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream(device) -> int:
    """The handle of PyTorch's current stream on ``device``: the raw
    handle, as ``torch.cuda.current_stream(device).cuda_stream`` gives it,
    without building a Stream object (some 10 µs of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def device_guard(device):
    """``torch.cuda.device(device)``, or no context where ``device`` is the
    current device already (the usual case: a few µs a launch saved)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (it returns
    ``cudaGetLastError()`` right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
