#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process.

    python3 portbench/calibrate.py --workload mamba2_370m.train_rns \
        --seeds 101-112 --control-seeds 101-103 --fault-seeds 101-103 \
        --faults half_batch

* lower: the program's numbers on each seed (its set-up steps against the
  reference, a window of one step);
* control: the reference with fp8 products (``reference/fp8.py``) in the
  program's place, against the f32 reference;
* faults: the program with the timed path broken, each of the cell's
  entry's ``FAULTS`` (a training entry: the state unchanged, which reads
  1 on the gradient and update gaps by their definition; half of each
  batch left out, the mean over the rest; on a repairing entry, the
  repair skipped).

One JSON line a reading, then a summary line: per number the largest
lower reading and the smallest control and fault readings.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def calibrate(root, name, seeds, control_seeds, fault_seeds, device,
              model=None, traffic=None, faults=None, emit=print) -> dict:
    """Run the readings; returns the summary.  ``faults``: names of the
    entry's ``FAULTS`` to read (all by default)."""
    import torch

    from portbench import harness

    device = torch.device(device)
    cell = harness.load_cell(root, name)
    m = dict(model or cell.config["model"])
    tr = dict(cell.traffic, **(traffic or {}))
    entry = harness.load_plugin(root, "entries", tr["entry"])
    family = harness.load_plugin(root, "families", m["family"])
    lower, control, read = [], [], {}

    def program(seed, wrap=None):
        lines = []
        harness.run_cell(root, name, seed, 0.0, False, device,
                         time.perf_counter(), model=m, traffic=traffic,
                         wrap_step=wrap, log=lines.append)
        got = [json.loads(ln) for ln in lines]
        return next({k: v for k, v in g.items() if k != "portbench"}
                    for g in got if g["portbench"] == "numbers")

    for seed in seeds:
        lower.append(program(seed))
        emit(json.dumps({"reading": "lower", "seed": seed, **lower[-1]}))
    for seed in control_seeds:
        ctx = harness.Run(root=Path(root), cell=cell, model=m, traffic=tr,
                          family=family, seed=seed, seconds=0.0, trace=False,
                          device=device, t0=time.perf_counter())
        control.append(entry.control(ctx))
        emit(json.dumps({"reading": "control", "seed": seed, **control[-1]}))
    for fault, wrap in entry.FAULTS.items():
        if faults is not None and fault not in faults:
            continue
        read[fault] = []
        for seed in fault_seeds:
            read[fault].append(program(seed, wrap))
            emit(json.dumps({"reading": fault, "seed": seed,
                             **read[fault][-1]}))
    summary = {"cell": name}
    if lower:
        summary["lower_max"] = {k: max(r[k] for r in lower)
                                for k in lower[0]}
    if control:
        summary["control_min"] = {k: min(r[k] for r in control)
                                  for k in control[0]}
    for fault, rs in read.items():
        if rs:
            summary[f"{fault}_min"] = {k: min(r[k] for r in rs)
                                       for k in rs[0]}
    emit(json.dumps({"summary": summary}))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="101-112")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--fault-seeds", default="101-103")
    ap.add_argument("--faults", default=None,
                    help="comma-separated names of the entry's faults "
                    "(default: all)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    calibrate(ROOT, args.workload, _seeds(args.seeds),
              _seeds(args.control_seeds), _seeds(args.fault_seeds),
              torch.device("cuda", 0),
              faults=args.faults.split(",") if args.faults else None,
              emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
