#!/usr/bin/env python3
"""Where a full-width serve decode step's time goes on one NVIDIA Hopper
card.

    python3 tools/serve_profile.py [--arch NAME] [--trace-dir DIR]
                                   [--page-size N]

Builds ``chip_smoke.py``'s serve engine shape (``--arch``, gemma3-1b by
default, at full width and depth, random weights from seed 0;
``ContinuousBatcher`` with 8 slots of 2048 positions, chunked prefill of
256), fills every slot with a 1024-token prompt drawn from a seed (no
request retires during the run), and measures the batched decode step two
ways:

* ``f32_params`` — the engine as it serves: f32 parameters, each weight
  cast to bf16 where a layer uses it, every step;
* ``bf16_params`` — the same step on a copy of the parameters cast to bf16
  once.  A cast is exact and deterministic, so the step computes the same
  bits; the tool checks that the sampled tokens are equal.  Left out, with
  a line saying so, when the copy does not fit in the card's free memory
  (qwen2-moe-a2.7b: 56 GB of f32 parameters and a 28 GB copy);
* ``paged`` (with ``--page-size N``) — the same prompts on a second engine
  over the paged pool, pages of N tokens: the step reads and writes the
  pool through its page table, scattering the new K/V and gathering each
  row's logical K/V (every layer copies 8 x 2048 positions of K and of V
  out of the pool); f32 parameters as served.  Its tokens must equal the
  batched step's too.  Every summary adds the device ms and launches a
  step of the pool's index kernels (``index_kernels``: the gather, and the
  scatter that the batched step makes too).

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


# the pool's index kernels, by a piece of their names: the gather of each
# row's logical K/V (``k_pool[pages]``) and the scatter of the new K/V
# (an index write; the batched step makes one too)
INDEX_KERNELS = {"gather": "vectorized_gather_kernel",
                 "scatter": "index_put_kernel"}


def index_kernels(trace_path: str, span: str) -> dict:
    """Device ms and launches per step of the pool's gather and scatter
    kernels (``INDEX_KERNELS``) inside the ``span`` spans of a Chrome
    trace (``.json`` or ``.json.gz``)."""
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == span and e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    out = {}
    for kind, piece in INDEX_KERNELS.items():
        hits = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "kernel" and piece in e["name"]
                and any(s <= e["ts"] < t for s, t in spans)]
        out[kind] = {"ms_per_step": sum(e["dur"] for e in hits) / 1e3
                     / len(spans), "launches_per_step": len(hits) / len(spans)}
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from train_profile import summarize

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b",
                    help="the model, at full width and depth")
    ap.add_argument("--trace-dir", default=TRACE_DIR)
    ap.add_argument("--page-size", type=int, default=None,
                    help="also profile the paged decode step, pages of "
                         "this many tokens")
    args = ap.parse_args(argv)
    out_dir = args.trace_dir
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.dist._tree import flatten_named
    from repro_torch.models import decode_step, init_params
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    os.makedirs(out_dir, exist_ok=True)
    cfg = get_config(args.arch)
    params = init_params(cfg, 0, dev)

    def engine(**kw):
        """The engine, its 8 slots admitted; (engine, admission s)."""
        eng = ContinuousBatcher(cfg, params, n_slots=SLOTS,
                                cache_len=CACHE_LEN, prefill_chunk=CHUNK,
                                **kw)
        rng = np.random.default_rng(0)
        for rid in range(SLOTS):
            eng.submit(Request(rid=rid, max_new=CACHE_LEN - PROMPT, prompt=[
                int(t) for t in rng.integers(1, cfg.vocab, PROMPT)]))
        t0 = time.perf_counter()
        eng.try_admit()
        torch.cuda.synchronize(dev)
        return eng, time.perf_counter() - t0

    eng, admit_s = engine()
    variants = {"f32_params": params}
    bf16_bytes = sum(2 * p.numel() for _, p in flatten_named(params))
    if bf16_bytes < torch.cuda.mem_get_info(dev)[0]:
        variants["bf16_params"] = cast_tree(params)
    else:
        print(json.dumps({"bf16_params": "left out", "bytes": bf16_bytes,
                          "free": torch.cuda.mem_get_info(dev)[0]}),
              flush=True)
    # the decode step as the engine makes it, on a copy of its state, so
    # the variants step from the same cache, tokens and positions
    toks, poss = eng.sched.step_rows()
    tokens = torch.tensor(toks, device=dev)[:, None]
    caches = {label: {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                      for k, v in eng.cache.items()} for label in variants}
    extra = {label: {} for label in variants}
    admit = {label: admit_s for label in variants}
    if args.page_size:
        paged, admit["paged"] = engine(page_size=args.page_size)
        for slot in paged.sched.decoding_slots():   # the step's write barrier
            paged.sched.plan_write(slot, slot.next_pos, 1)
        variants["paged"] = params
        caches["paged"] = {k: (v.clone() if isinstance(v, torch.Tensor)
                               else v) for k, v in paged.cache.items()}
        extra["paged"] = {"pages": paged._table(paged.sched.table),
                          "page_size": args.page_size}
        del eng

    def step(label):
        with record_function("decode_step"):
            logits, _ = decode_step(cfg, variants[label], caches[label],
                                    tokens, poss, **extra[label])
            nxt = torch.argmax(logits, dim=-1)
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
                logits, _ = decode_step(cfg, p, caches[label], tokens,
                                        poss, **extra[label])
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
        out["index_kernels"] = index_kernels(path, "decode_step")
        if label == "paged":
            out["page_size"] = args.page_size
        out.update({"arch": cfg.name, "slots": SLOTS, "cache_len": CACHE_LEN,
                    "prompt": PROMPT, "admit_s": admit[label],
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
    same = all(v == sampled["f32_params"] for v in sampled.values())
    print(json.dumps({"tokens_equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
