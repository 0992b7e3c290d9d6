#!/usr/bin/env python3
"""DTensor's host cost on one NVIDIA Hopper card: gemma3-1b's training
step and the paged engine's decode step with and without a (1, 1) mesh.

    python3 tools/mesh_overhead.py [--steps N] [--max-new N]

On ``launch.mesh.make_host_mesh()`` (one NCCL rank) the tool builds
gemma3-1b at full width and depth twice from one seed: plain tensors, and
DTensors placed by ``dist.sharding``'s spec trees (ZeRO-1 moments,
gradients pinned).  It runs WARMUP fp32 steps each way, then ``--steps``
more (batch 2 x seq 1024, ``chip_smoke.py``'s shapes), in lockstep and
holding every parameter bit-equal after each, and prints the median and
the spread of each way's step ms (host clock after a synchronize); then
one more step each way under ``torch.profiler``: its device events
(kernels, copies and sets) and the device's busy ms.  Then the paged
engine of ``chip_smoke.py``'s phase 5f (pages of 512, ``--rns-verify``, 4
requests behind the 1,024-token prefix) with and without ``mesh=``,
``--max-new`` tokens each: the tokens equal, and each way's median decode
step.  Prints the card's name and
power limit (``nvidia-smi``) first and one JSON object a part.  Exits 1
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

WARMUP = 2


def spread(ms: list) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "steps": len(ms)}


def profiled(fn, torch):
    """``fn()`` once under ``torch.profiler``: (device events, device busy
    ms as the union of their intervals)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return len(spans), busy / 1e3


def train(dev, mesh, steps: int, torch) -> dict:
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.dist import _tree
    from repro_torch.dist import sharding as sh
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(cs.MESH_ARCH)
    params = init_params(cfg, 0, dev)
    ps = sh.param_specs(params, mesh)
    zs = sh.opt_state_specs(params, ps, mesh, zero1=cfg.zero1)
    place = lambda tree, specs: _tree.tree_map(
        sh.place_host, tree, sh.named_shardings(specs, mesh))
    st = adamw_init(params)
    state = {"plain": (params, st),
             "mesh": (place(params, ps),
                      {"m": place(st["m"], zs), "v": place(st["v"], zs),
                       "step": st["step"]})}
    fns = {"plain": make_train_step(cfg, AdamWConfig()),
           "mesh": make_train_step(cfg, AdamWConfig(), mesh=mesh,
                                   grad_shardings=sh.named_shardings(ps,
                                                                     mesh))}
    gen = torch.Generator(device=dev).manual_seed(5)
    ms = {"plain": [], "mesh": []}

    def step(side, batch):
        b = (batch if side == "plain" else
             place(batch, sh.batch_specs(batch, mesh)))
        p, o, _ = fns[side](*state[side], b)
        state[side] = (p, o)

    for i in range(WARMUP + steps + 1):
        batch = {"tokens": torch.randint(0, cfg.vocab, (cs.MESH_BATCH,
                                                        cs.MESH_SEQ + 1),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
        for side in ("plain", "mesh"):
            if i == WARMUP + steps:
                launches, busy = profiled(lambda: step(side, batch), torch)
                ms[side + "_launches"], ms[side + "_busy_ms"] = launches, busy
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(side, batch)
            torch.cuda.synchronize()
            if i >= WARMUP:
                ms[side].append((time.perf_counter() - t0) * 1e3)
        for (name, a), b in zip(_tree.flatten_named(state["plain"]),
                                _tree.flatten(state["mesh"])[0]):
            b = b.to_local() if hasattr(b, "to_local") else b
            if not cs.bits_equal(a, b):
                raise SystemExit(f"step {i}: {name} differs from no mesh")
    return {"part": "train", "arch": cs.MESH_ARCH, "bit_equal": True,
            **{f"{s}_step_ms": spread(ms[s]) for s in ("plain", "mesh")},
            **{k: v for k, v in ms.items() if k.endswith(("launches",
                                                          "busy_ms"))}}


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("mesh_overhead: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=48)
    args = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_host_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    mesh = make_host_mesh()
    try:
        print(json.dumps(train(dev, mesh, args.steps, torch)), flush=True)
        cs.free_card()
        cs.WARM_MAX_NEW = args.max_new
        serve = cs.mesh_serve(dev, mesh)
        print(json.dumps({"part": "serve", "max_new": args.max_new,
                          **serve}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
