#!/usr/bin/env python3
"""How far a full-width MoE serve engine's logits sit from a teacher-forced
forward when no token can drop, and where the distance comes from: the
router's expert choice, layer by layer.

    python3 tools/moe_routing.py [--arch qwen2-moe-a2.7b] [--rids 7,15]

Draws ``chip_smoke.py``'s phase-6d workload (``MOE_SERVE_ARGS``: 16
Poisson(1024) prompts from seed 0), builds the arch at full width and depth
with random weights from seed 0, and serves the chosen requests through
``ContinuousBatcher`` (8 slots of 2048 positions, chunk 256) at capacity
factor E/K, where every call's capacity holds all its tokens, once in the
config's compute dtype (bf16) and once in f32.  For each run and request:

* the engine's logits (the last prompt position, then each decode step)
  against a teacher-forced ``train_logits`` over prompt + out[:-1]: the
  largest difference, its share of the forward's largest |logit|
  (``chip_smoke.SERVE_LOGIT_TOL`` bounds it at 2**-4), and the positions
  past that bound;
* the routing of the prompt's tokens: the expert set each layer's router
  chose for each prompt token in the engine's prefill chunks against the
  forward's, the token-layer pairs whose sets differ, by layer.

Prints the card's name and power limit (``nvidia-smi``) first, then one
JSON line per (dtype, request).  Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=cs.MOE_ARCH)
    ap.add_argument("--rids", default="7,15")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_routing: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synth_requests
    from repro_torch.models import init_params, moe

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    opt = lambda flag: cs.MOE_SERVE_ARGS[cs.MOE_SERVE_ARGS.index(flag) + 1]
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = init_params(cfg, 0, dev)
    reqs = synth_requests(
        int(opt("--requests")), np.random.default_rng(int(opt("--seed"))),
        cfg.vocab, prompt_mean=int(opt("--prompt-mean")),
        max_new=int(opt("--max-new")),
        arrival_rate=float(opt("--arrival-rate")))
    rids = [int(r) for r in args.rids.split(",")]

    calls = []
    orig_route = moe.route

    def route(router, x, K):
        out = orig_route(router, x, K)
        calls.append(out[2])
        return out

    moe.route = route
    try:
        for dtype in (cfg.dtype, "float32"):
            run_cfg = dataclasses.replace(
                cfg, dtype=dtype, capacity_factor=cfg.n_experts / cfg.top_k)
            for rid in rids:
                print(json.dumps(measure(cs, run_cfg, params, reqs[rid], opt,
                                         calls, dev)), flush=True)
                torch.cuda.empty_cache()
    finally:
        moe.route = orig_route
    return 0


def measure(cs, cfg, params, want, opt, calls, dev) -> dict:
    """Serve ``want``'s prompt alone at ``cfg``, then the teacher-forced
    forward; the logit distance and the prompt's routing flips by
    layer."""
    import torch

    from repro_torch.models import train_logits
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    chunk = int(opt("--prefill-chunk"))
    eng = ContinuousBatcher(cfg, params, n_slots=int(opt("--slots")),
                            cache_len=int(opt("--cache-len")),
                            prefill_chunk=chunk)
    r = Request(rid=want.rid, prompt=list(want.prompt), max_new=want.max_new)
    plen, L = len(r.prompt), cfg.n_layers
    n_chunks = -(-plen // chunk)
    calls.clear()
    with cs.ServeProbe(keep_logits=[r.rid]) as probe:
        eng.submit(r)
        eng.run_to_completion()
    got = probe.logits_of(r.rid).float()
    prefill = calls[:n_chunks * L]          # chunk by chunk, layer by layer
    calls.clear()
    with torch.inference_mode():
        # padded to whole attention chunks: at the no-drop capacity the
        # pads take no token's place, and causality keeps them out of the
        # compared positions
        seq = r.prompt + r.out[:-1]
        toks = torch.tensor([seq + [0] * (-len(seq) % cs.ATTN_CHUNK)],
                            device=dev)
        fwd, _ = train_logits(cfg, params, {"tokens": toks})
    fwd = fwd[0, plen - 1:plen - 1 + len(r.out)].float()
    diff = (got - fwd).abs().amax(dim=-1)
    scale = float(fwd.abs().max())
    bound = cs.SERVE_LOGIT_TOL * scale
    flips = []
    for layer in range(L):
        eng_idx = torch.cat([prefill[c * L + layer][0]
                             for c in range(n_chunks)])[:plen]
        fwd_idx = calls[layer][0][:plen]
        flips.append(int((eng_idx.sort(dim=-1).values
                          != fwd_idx.sort(dim=-1).values).any(dim=-1).sum()))
    past = [i for i, d in enumerate(diff.tolist()) if d > bound]
    return {"arch": cfg.name, "dtype": cfg.dtype, "rid": r.rid,
            "plen": plen, "positions": len(r.out),
            "capacity_factor": cfg.capacity_factor,
            "max_abs_diff": float(diff.max()), "max_abs_logit": scale,
            "diff_share": float(diff.max()) / scale,
            "tolerance_share": cs.SERVE_LOGIT_TOL,
            "positions_past_tolerance": len(past),
            "first_position_past_tolerance": past[0] if past else None,
            "tokens_equal_forward_argmax":
                r.out == fwd.argmax(dim=-1).tolist(),
            "prompt_routing_flips_by_layer": flips,
            "first_layer_with_a_flip": next(
                (i for i, f in enumerate(flips) if f), None),
            "token_layer_pairs": plen * L}


if __name__ == "__main__":
    sys.exit(main())
