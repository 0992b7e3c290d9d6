#!/usr/bin/env python3
"""Where the crypto lane's divmods spend their time, on one NVIDIA Hopper card.

    python3 tools/divmod_host.py

Runs ``chip_smoke.py``'s crypto lane (RSA-2048 width: 1,024 slots, 1,024
modexps, 64 modmuls, 4 divmods, every result checked) four times in one
process, Python's garbage collector on and off in turn (off: collected,
then disabled for the whole lane), and prints, for each run, the lane's
wall time, the collector's passes during it, and each divmod's host
milliseconds, its span between two CUDA events and its compare launches.
Then one divmod alone at the lane's width, as the engine calls
it, by the host clock and under cProfile: the host seconds of the
functions that take the most, and the calls of each torch operation it
makes (the host work of its 2 * 2062 + 1 comparison steps).  Prints the
card's name and power limit first.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import cProfile
import gc
import os
import pstats
import random
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

GC_RUNS = (True, False, True, False)   # the collector on in each run
TOP = 15


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("divmod_host: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.division import _divmod_impl
    from repro_torch.kernels import build
    from repro_torch.serve.crypto import CryptoContext

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    build.load()
    for run, gc_on in enumerate(GC_RUNS):
        if not gc_on:
            gc.collect()
            gc.disable()
        passes = sum(g["collections"] for g in gc.get_stats())
        try:
            lane = chip_smoke.crypto_main_path(dev)
        finally:
            gc.enable()
        chip_smoke.emit({"run": run, "gc": gc_on, "lane_s": lane["seconds"],
                         "gc_passes": sum(g["collections"]
                                          for g in gc.get_stats()) - passes,
                         "divmod": lane["divmod"]})

    ctx = CryptoContext(n_limbs=chip_smoke.CRYPTO_LIMBS,
                        exp_bits=chip_smoke.CRYPTO_EXP_BITS)
    rng = random.Random(15)
    M = ctx.baseB.M

    def rows(v):
        row = np.asarray(ctx.encode_lo(v)[: ctx.n + 1], np.int32)
        return torch.from_numpy(row)[None].to(dev)

    xp, dp = rows(rng.randrange(M)), rows(rng.randrange(1, M))
    _divmod_impl(ctx.baseB, xp, dp)                    # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    _divmod_impl(ctx.baseB, xp, dp)
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t)
    prof = cProfile.Profile()
    prof.enable()
    _divmod_impl(ctx.baseB, xp, dp)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    by_time = sorted(stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    torch_calls = {name: v[1] for (_, _, name), v in stats.items()
                   if "torch" in name or "TensorBase" in name}
    chip_smoke.emit({
        "divmod_alone_ms": alone_ms,
        "profiled_s": sum(v[2] for v in stats.values()),
        "top_tottime_s": [{"function": f"{os.path.basename(f)}:{line}:{name}",
                           "calls": v[1], "tottime_s": v[2],
                           "cumtime_s": v[3]}
                          for (f, line, name), v in by_time],
        "torch_calls": dict(sorted(torch_calls.items(),
                                   key=lambda kv: -kv[1]))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
