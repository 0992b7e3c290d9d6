#!/usr/bin/env python3
"""Where a full-width serve decode step's time goes on one NVIDIA Hopper
card.

    python3 tools/serve_profile.py [--trace-dir DIR]

Builds ``chip_smoke.py``'s serve engine shape (gemma3-1b at full width,
``ContinuousBatcher`` with 8 slots of 2048 positions, chunked prefill of
256), fills every slot with a 1024-token prompt drawn from a seed (no
request retires during the run), and measures the batched decode step two
ways:

* ``f32_params`` — the engine as it serves: f32 parameters, each weight
  cast to bf16 where a layer uses it, every step;
* ``bf16_params`` — the same step on a copy of the parameters cast to bf16
  once.  A cast is exact and deterministic, so the step computes the same
  bits; the tool checks that the sampled tokens are equal.

For each: the median over ROUNDS x STEPS steps of the host clock around a
synchronised step and of the CUDA events around the model call (the
variants take turns, round by round, and all before any profiler session,
which leaves host work behind it), then PROFILED steps under
``torch.profiler`` (each under a ``decode_step`` span):
wall ms, the device's busy ms and idle share, launches a step, device ms by
kind and the TOP kernels (``tools/train_profile.py``'s summary).  The
Chrome traces go to ``DIR/serve_profile_<variant>.json.gz`` (default
``experiments/serve_profile``, git-ignored).  Prints the card's name and
power limit (``nvidia-smi``) first.  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SLOTS, CACHE_LEN, CHUNK, PROMPT = 8, 2048, 256, 1024
WARMUP, ROUNDS, STEPS, PROFILED = 3, 4, 10, 3
TRACE_DIR = os.path.join(ROOT, "experiments", "serve_profile")


def cast_tree(tree):
    """A copy of a parameter tree with every leaf cast to bf16."""
    import torch

    if isinstance(tree, dict):
        return {k: cast_tree(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from train_profile import summarize

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    out_dir = ap.parse_args(argv).trace_dir
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config("gemma3-1b")
    params = init_params(cfg, 0, dev)
    eng = ContinuousBatcher(cfg, params, n_slots=SLOTS, cache_len=CACHE_LEN,
                            prefill_chunk=CHUNK)
    rng = np.random.default_rng(0)
    for rid in range(SLOTS):
        eng.submit(Request(rid=rid, max_new=CACHE_LEN - PROMPT, prompt=[
            int(t) for t in rng.integers(1, cfg.vocab, PROMPT)]))
    t0 = time.perf_counter()
    eng.try_admit()
    torch.cuda.synchronize(dev)
    admit_s = time.perf_counter() - t0
    variants = {"f32_params": params, "bf16_params": cast_tree(params)}
    # the decode step as the engine makes it, on a copy of its state, so
    # both variants step from the same cache, tokens and positions
    toks, poss = eng.sched.step_rows()
    tokens = torch.tensor(toks, device=dev)[:, None]
    caches = {label: {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in eng.cache.items()} for label in variants}

    def step(label):
        with record_function("decode_step"):
            nxt, _ = eng._decode_impl(variants[label], caches[label],
                                      tokens, poss)
            torch.cuda.synchronize(dev)
        return nxt

    sampled = {}
    for label in variants:
        for _ in range(WARMUP):
            sampled[label] = step(label).tolist()
    times = {label: {"host": [], "enqueue": [], "event": []}
             for label in variants}
    for _ in range(ROUNDS):
        for label, p in variants.items():
            t_ = times[label]
            for _ in range(STEPS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t = time.perf_counter()
                e0.record()
                logits, _ = decode_step(eng.cfg, p, caches[label], tokens,
                                        poss)
                e1.record()
                t_["enqueue"].append(time.perf_counter() - t)
                torch.argmax(logits, dim=-1).tolist()
                t_["host"].append(time.perf_counter() - t)
                t_["event"].append(e0.elapsed_time(e1))
    for label in variants:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                step(label)
        path = os.path.join(out_dir, f"serve_profile_{label}.json")
        prof.export_chrome_trace(path)
        out = summarize(path, label, span="decode_step")
        t_ = times[label]
        host = statistics.median(t_["host"])
        out.update({"slots": SLOTS, "cache_len": CACHE_LEN,
                    "prompt": PROMPT, "admit_s": admit_s,
                    "step_host_ms_median": 1e3 * host,
                    "step_enqueue_ms_median":
                        1e3 * statistics.median(t_["enqueue"]),
                    "step_event_ms_median": statistics.median(t_["event"]),
                    "tokens_per_s": SLOTS / host,
                    "launches_per_step": out["launches"] / out["steps"]})
        print(json.dumps(out), flush=True)
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(path)
        del prof
    same = sampled["f32_params"] == sampled["bf16_params"]
    print(json.dumps({"tokens_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
