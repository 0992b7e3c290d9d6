#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this machine holds.

    python3 portbench/run.py --workload mamba2_370m.train_rns --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (CUDA events around the
step's stages, then a few more steps under ``torch.profiler``).  Earlier
lines on standard output say how the run went; the last is one JSON
object.  Each number compared with the reference goes to standard error
beside its limit, last there.  Exits non-zero, printing no result, without
enough CUDA devices, without the program beside it, or when the JAX stack
or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout, set before
# torch loads (the port's own kernels build into src/repro_torch/kernels/_build)
_CACHE = ROOT / "_portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(_CACHE / sub)


def _power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import guard, harness

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0)
    print(json.dumps({"portbench": "card", "nvidia_smi": _power_line()}))
    found = guard.loaded_forbidden()
    if found:
        print("portbench: modules of the JAX stack or the JAX package are "
              f"loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:   # the run's boundary: report, print no result
        traceback.print_exc()
        sys.exit(1)
