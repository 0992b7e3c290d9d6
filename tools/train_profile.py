#!/usr/bin/env python3
"""Where a full-width training step's time goes on one NVIDIA Hopper card.

    python3 tools/train_profile.py [--arch NAME] [--trace-dir DIR]

Runs ``--arch`` (default gemma3-1b) at full width and depth
(``chip_smoke.py``'s training shapes: batch 2 x seq 1024, one rank) through
``repro_torch.train.train_step`` on the fp32 path and on the RNS codec
path (``GradCodec.make(world=2)`` on a one-rank NCCL group), warms each up
for WARMUP steps and then records STEPS steps under ``torch.profiler``
(CPU and CUDA activities), each step under a ``record_function`` span and
synchronised at its end.

For each path it prints one JSON object: the steps' wall ms (the spans),
the device's busy ms inside them (the union of kernel, memcpy and memset
intervals) and its idle share, the device ms by kind of kernel (matrix
products, the codec kernels, the rest by name) and the TOP kernels by
device time with their launch counts, and the device ms a step of each of
the program's spans (``repro_torch.spans``: ``ssm.ssd`` and
``ssm.ssd.bwd``, the SSD core's forward and backward, ``remat.recompute``,
the recomputation under remat, ...); the Chrome trace goes to
``DIR/train_profile_<arch>_<path>.json.gz`` (default
``experiments/train_profile``, git-ignored).  Prints the card's name and
power limit (``nvidia-smi``) first.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WARMUP, STEPS, TOP = 2, 2, 25
TRACE_DIR = os.path.join(ROOT, "experiments", "train_profile")
# substrings of kernel names, by kind (the first match wins)
KINDS = (("matmul", ("gemm", "cutlass", "xmma", "sm90_", "nvjet")),
         ("codec", ("codec_encode_kernel", "codec_decode_kernel")),
         ("reduce", ("reduce_kernel", "softmax", "logsumexp")),
         ("elementwise", ("elementwise", "vectorized", "unrolled")),
         ("index", ("index", "gather", "scatter", "embedding")))


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def busy_ms(intervals, lo, hi) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi),
    in ms (trace times are microseconds)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def summarize(trace_path: str, label: str, span: str = "train_step") -> dict:
    """The JSON object of one path from its Chrome trace (``.json`` or
    ``.json.gz``); the steps are the host-side ``span`` spans."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == span and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    if not spans or not device:
        raise RuntimeError(f"profile: the trace of {label} holds "
                           f"{len(spans)} step spans and {len(device)} "
                           "device events")
    wall = sum(e - s for s, e in spans) / 1e3
    busy = sum(busy_ms([(e["ts"], e["ts"] + e["dur"]) for e in device], s, t)
               for s, t in spans)
    by_name, by_kind = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in device:
        if not any(s <= e["ts"] < t for s, t in spans):
            continue
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        by_name[name][0] += e["dur"] / 1e3
        by_name[name][1] += 1
        by_kind[kind_of(name) if e["cat"] == "kernel" else e["cat"]] += (
            e["dur"] / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    # a span's device range: its first to its last own kernel (a kernel
    # falls under its innermost open range)
    by_span = defaultdict(float)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                and e.get("name") != span):
            by_span[e["name"]] += e["dur"] / 1e3 / len(spans)
    return {"path": label, "steps": len(spans), "wall_ms": wall,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "launches": sum(n for _, n in by_name.values()),
            "top": [{"name": n[:160], "ms": ms, "launches": k}
                    for n, (ms, k) in top],
            "span_device_ms": dict(sorted(by_span.items(),
                                          key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile, record_function

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    args = ap.parse_args(argv)
    out_dir = args.trace_dir
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import build
    from repro_torch.launch.train import init_group, make_rns_dp_step
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, SyntheticLM, adamw_init
    from repro_torch.train.train_step import make_train_step

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.load()
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config(args.arch)
    opt_cfg = AdamWConfig(warmup=5, decay_steps=10)
    loader = SyntheticLM(cfg, seq=1024, batch=2)
    init_group(dev)
    try:
        paths = {"fp32": make_train_step(cfg, opt_cfg),
                 "rns": make_rns_dp_step(cfg, opt_cfg,
                                         GradCodec.make(world=2))[0]}
        for label, step_fn in paths.items():
            torch.cuda.empty_cache()
            params = init_params(cfg, 0, dev)
            opt = adamw_init(params)

            def step(i):
                nonlocal params, opt
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in loader.batch_at(i).items()}
                with record_function("train_step"):
                    params, opt, _ = step_fn(params, opt, batch)
                    torch.cuda.synchronize(dev)

            for i in range(WARMUP):
                step(i)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(WARMUP, WARMUP + STEPS):
                    step(i)
            path = os.path.join(out_dir,
                                f"train_profile_{cfg.name}_{label}.json")
            prof.export_chrome_trace(path)
            print(json.dumps(summarize(path, label)), flush=True)
            with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
                shutil.copyfileobj(f, g)
            os.remove(path)
            del params, opt, prof
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
