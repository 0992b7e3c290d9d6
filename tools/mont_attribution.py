#!/usr/bin/env python3
"""Where the Montgomery kernels' time goes, on one NVIDIA Hopper card.

    python3 tools/mont_attribution.py

Builds ``src/repro_torch/kernels/csrc/mont_ladder.cu`` as it is and in
variants that each leave one part of the work out:

    no_mrc    the two MRC triangles of each product
    no_dot    the four tensor-core base-extension dots
    no_stage  the cp.async copy of the table image into shared memory
    no_load   the operand loads (values made from the lane and column)
    no_store  the output stores (kept only behind a test that never holds)

and times every variant's ``rns_mont_mul`` and ``rns_mont_ladder``, and the
whole kernel's with 8-column blocks at every width (``cols8``; the launch
otherwise takes 16 where that still gives every SM a block, ``block_cols``),
with CUDA events at RSA-2048 width (``CryptoContext(n_limbs=138)``) on 8,192 and on
1,024 columns: ten launches back to back through the C entry points (no
Python wrapper), the median of 20 such runs, per launch.  A variant's values
are wrong; its gap to the full kernel is the time of the part it leaves
out.  Also times the Python wrapper (``mont_ladder_kernel_call``): one
launch alone, as ``chip_smoke.py`` times it, and ten back to back, and its
host time per call.

Prints the card's name and power limit (``nvidia-smi``), then one JSON object
per width.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import random
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
WIDTHS = (8192, 1024)


def _sub(text: str, pattern: str, repl: str, flags=0) -> str:
    out, n = re.subn(pattern, repl, text, flags=flags)
    if n == 0:
        raise RuntimeError(f"mont_attribution: {pattern!r} not in the source")
    return out


# Each variant edits one file of the build: mont_ladder.cu, or the MRC
# triangle's header it includes (mrc_warp.cuh, whose operand loader the
# Montgomery kernels share with the column kernels).
VARIANTS = {
    "full": ("mont_ladder.cu", lambda s: s),
    "no_mrc": ("mont_ladder.cu",
               lambda s: _sub(s, r"\n  rns::mrc_warp<kSlots>\([^;]*;", "")),
    "no_dot": ("mont_ladder.cu",
               lambda s: _sub(s, r"\n  dot_mma<C>\([^;]*;", "")),
    "no_stage": ("mont_ladder.cu",
                 lambda s: _sub(s, r'asm volatile\("cp\.async\.cg.*?: "memory"\);',
                                "(void)dst;", re.S)),
    "no_load": ("mrc_warp.cuh",
                lambda s: _sub(s, r"\? p\[col \* cs \+ \(int64_t\)\(rows - 1 - r\) \* chs\]",
                               "? (int)((l + col) & 255)")),
    "no_store": ("mont_ladder.cu",
                 lambda s: _sub(s, r"if \(i < cols\) p\[",
                                "if (i < cols && B < 0) p[")),
}


def build_variants(tmp: str) -> dict:
    """One shared library per variant, the nvcc processes run together."""
    from repro_torch.kernels import build

    procs = {}
    for name, (target, edit) in VARIANTS.items():
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in ("mont_ladder.cu", "common.cuh", "mrc_warp.cuh"):
            shutil.copy(os.path.join(CSRC, f), d)
        with open(os.path.join(d, target), "w") as f:
            f.write(edit(open(os.path.join(CSRC, target)).read()))
        so = os.path.join(d, "lib.so")
        cmd = [build._nvcc(), *build._ARCH, *build._FLAGS, "-shared", "-o",
               so, os.path.join(d, "mont_ladder.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"mont_attribution: nvcc failed for {name}:\n"
                               + log)
        lib = ctypes.CDLL(so)
        for fn in ("rns_mont_mul", "rns_mont_ladder"):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def per_launch_ms(torch, fn, inner: int, runs: int = 20, warmup: int = 3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mont_attribution: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import ops
    from repro_torch.kernels.mont_ladder import (_layout_arg, block_cols,
                                                 mont_ladder_kernel_call)
    from repro_torch.serve.crypto import CryptoContext

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    ctx = CryptoContext(n_limbs=138, exp_bits=2048)
    image = ops._mont_image(ctx.baseB, ctx.baseBp, ctx.lo_targets, dev)
    shape = (ctx.n, ctx.nch_lo, ctx.n_hi)
    base_cols = chip_smoke.crypto_columns(ctx, 512, random.Random(8192), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        for B in WIDTHS:
            xl, xh, yl, yh, neg, nhi = (
                c.repeat(1, -(-B // 512))[:, :B].contiguous()
                for c in base_cols)
            bit = torch.randint(0, 2, (B,), generator=gen, device=dev,
                                dtype=torch.int32)
            outs = [torch.empty_like(t) for t in (xl, xh, xl, xh)]
            stream = torch.cuda.current_stream(dev).cuda_stream
            ptr = lambda *ts: [t.data_ptr() for t in ts]
            runs = {name: (lib, block_cols(B, dev))
                    for name, lib in libs.items()}
            runs["cols8"] = (libs["full"], 8)
            row = {"batch": B, "shape": list(shape), "card": card,
                   "cols": block_cols(B, dev), "ms_per_launch": {}}
            for name, (lib, cols) in runs.items():
                layout = _layout_arg(*shape, cols)
                mul_args = (*ptr(xl, xh, yl, yh, neg, nhi, *outs[:2]),
                            image.data_ptr(), layout, B, stream)
                lad_args = (*ptr(xl, xh, yl, yh, bit, neg, nhi, *outs),
                            image.data_ptr(), layout, B, stream)
                row["ms_per_launch"][name] = {
                    "mont_mul": per_launch_ms(
                        torch, lambda: lib.rns_mont_mul(*mul_args), 10),
                    "mont_ladder": per_launch_ms(
                        torch, lambda: lib.rns_mont_ladder(*lad_args), 10)}
            call = lambda: mont_ladder_kernel_call(xl, xh, yl, yh, bit, neg,
                                                   nhi, image)
            row["wrapper_ladder_ms"] = {"alone": per_launch_ms(torch, call, 1),
                                        "ten": per_launch_ms(torch, call, 10)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(100):
                call()
            row["wrapper_host_us"] = (time.perf_counter() - t0) * 1e4
            torch.cuda.synchronize()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
