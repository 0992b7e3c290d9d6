"""Roofline report: dry-run records -> a markdown table, the reference's
``repro/launch/roofline_report.py`` over ``launch.dryrun``'s records.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
        --dryrun experiments/dryrun_torch --out experiments/roofline_torch.md

The terms are against the H100 SXM's spec-sheet peaks (``costs.HW``).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs import ALIASES, SHAPES, get_config, shape_cells
from .dryrun import DEFAULT_OUT

__all__ = ["load_records", "fmt_row", "HEADER", "main"]


def load_records(dryrun_dir):
    recs = {}
    for path in glob.glob(os.path.join(dryrun_dir, "*.json")):
        with open(path) as f:
            r = json.load(f)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_row(r):
    t = r["roofline"]
    mem = r["memory"]
    return (
        f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        f"| {t['compute_s']*1e3:.2f} | {t['memory_s']*1e3:.2f} "
        f"| {t['collective_s']*1e3:.2f} | **{t['bottleneck']}** "
        f"| {r['model_flops_per_device']/1e12:.2f} "
        f"| {t['flops_per_device']/1e12:.2f} "
        f"| {r['useful_flops_ratio']:.2f} "
        f"| {mem['per_device_bytes']/2**30:.1f} "
        f"| {'Y' if mem['fits_hbm'] else 'N'} |"
    )


HEADER = (
    "| arch | shape | mesh | compute ms | memory ms | collective ms | "
    "bottleneck | model TF/dev | counted TF/dev | useful | GiB/dev | fits |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|---|"
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default=DEFAULT_OUT)
    ap.add_argument("--out", default="experiments/roofline_torch.md")
    ap.add_argument("--mesh", default="single",
                    help="mesh for the main table (single|multi|both)")
    args = ap.parse_args(argv)
    recs = load_records(args.dryrun)

    lines = [HEADER]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    skipped = []
    for arch in ALIASES:
        cells = shape_cells(get_config(arch))
        for shape in SHAPES:
            if shape not in cells:
                skipped.append((arch, shape))
                continue
            for mesh in meshes:
                r = recs.get((arch, shape, mesh))
                lines.append(
                    fmt_row(r) if r else
                    f"| {arch} | {shape} | {mesh} | — | — | — | MISSING "
                    f"| — | — | — | — | — |"
                )
    lines.append("")
    lines.append("Skipped cells (full-attention archs at 500k decode):")
    for arch, shape in skipped:
        lines.append(f"- {arch} × {shape}: SKIP")
    out = "\n".join(lines)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(out + "\n")
    print(out)


if __name__ == "__main__":
    main()
