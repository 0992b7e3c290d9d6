#!/usr/bin/env python3
"""How many blocks the column kernels (mrc, compare) should launch, on one
NVIDIA Hopper card.

    python3 tools/column_grid.py

Each block stages its base's table image into shared memory once and then
walks its columns in a grid-stride loop, so the grid is capped:
``kernels/mrc.py::launch_geometry`` launches at most ``BLOCKS_PER_SM``
blocks an SM.  This times ``mrc_kernel_call`` and ``compare_kernel_call``
with that cap set to each of CAPS blocks an SM and with no cap (a block for
every 8 warps of columns), at ``chip_smoke.py``'s paper_n137 (n = 137,
2**20 columns) and quickstart_n8 (n = 8, 2**22 columns) shapes, on the
channels-last rows the main path holds: ten launches queued behind a sleep
on the card, per launch (the card's time alone), the median of 20 such
runs; each output first held against its plain version.

Prints the card's name and power limit (``nvidia-smi``), then one JSON
object a kernel and shape.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CAPS = (1, 2, 3, 4, 6, 8)
UNCAPPED = 1 << 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("column_grid: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs.paper_rns import make_paper_bases
    from repro_torch.core import Layout, RnsArray, backend, make_base
    from repro_torch.kernels import build, mrc, ops
    from repro_torch.kernels.rns_compare import (compare_kernel_call,
                                                 compare_plain)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    build.load()
    gen = torch.Generator(device=dev).manual_seed(15)
    for label, base, batch in (("paper_n137", make_paper_bases()[0],
                                chip_smoke.PAPER_BATCH),
                               ("quickstart_n8", make_base(8, bits=15),
                                chip_smoke.SMALL_BATCH)):
        m = base.tensor("moduli_np", dev, torch.int64)
        with backend("torch"):
            A, B = (RnsArray.from_parts(
                base, (torch.randint(0, 1 << 62, (batch, base.n),
                                     generator=gen, device=dev) % m)
                .to(torch.int32), device=dev).normalize(Layout.BASE_MA)
                    for _ in range(2))
        image = ops._column_image(base, dev)
        tables = [base.tensor(t, dev, torch.int32)
                  for t in ("inv_tri_np", "moduli_np", "betas_ma_np")]
        t1, a1, t2, a2 = A.x.T, A.xa, B.x.T, B.xa
        calls = {
            "mrc": (lambda: mrc.mrc_kernel_call(t1, image),
                    lambda: mrc.mrc_plain(t1, *tables[:2])),
            "compare": (lambda: compare_kernel_call(t1, a1, t2, a2, image,
                                                    base.ma),
                        lambda: compare_plain(t1, a1, t2, a2, *tables,
                                              base.ma)),
        }
        for name, (kern, plain) in calls.items():
            want = plain()
            row = {"kernel": name, "shape": label, "n": base.n,
                   "batch": batch, "sms": build.sm_count(dev),
                   "ms_device_by_blocks_per_sm": {}}
            for cap in CAPS + (UNCAPPED,):
                mrc.BLOCKS_PER_SM = cap
                got = kern()
                if not torch.equal(got.to(torch.int64), want.to(torch.int64)):
                    raise RuntimeError(f"column_grid: {name} disagrees with "
                                       f"its plain version at {label}, "
                                       f"{cap} blocks an SM")
                key = "uncapped" if cap == UNCAPPED else str(cap)
                row["ms_device_by_blocks_per_sm"][key] = chip_smoke.median_ms(
                    kern, inner=10, queued=True)
            chip_smoke.emit(row)
        del A, B, t1, t2, a1, a2
    return 0


if __name__ == "__main__":
    sys.exit(main())
