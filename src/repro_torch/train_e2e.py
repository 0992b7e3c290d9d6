"""End-to-end training driver evidence: a mid-size decoder (llama3.2-3b
cut to 8 layers, d 384, vocab 8,192: 15,735,168 parameters, as the
reference's ``init_params`` counts them) trained for
300 steps on the learnable synthetic stream, with a fingerprinted
checkpoint of its parameters and AdamW state every 100 steps
(``train/checkpoint.py``, the legacy step format) — the port of the
reference's ``examples/train_e2e.py``.

    PYTHONPATH=src python -m repro_torch.train_e2e                # card
    PYTHONPATH=src python -m repro_torch.train_e2e --device cpu \\
        --ckpt-dir /tmp/train_e2e_ck
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from .configs import get_config
from .dist._tree import flatten
from .models import init_params
from .train import checkpoint as ckpt
from .train.data import Prefetcher, SyntheticLM
from .train.optimizer import AdamWConfig, adamw_init
from .train.train_step import make_train_step

__all__ = ["main", "config", "STEPS", "SAVE_EVERY", "MAX_FINAL_LOSS"]

STEPS = 300
SAVE_EVERY = 100
MAX_FINAL_LOSS = 3.0     # ln(8192) = 9.01 at the start


def config():
    """The reference example's cut of llama3.2-3b (15.7M parameters)."""
    cfg = dataclasses.replace(
        get_config("llama3.2-3b").smoke(),
        n_layers=8, d_model=384, n_heads=6, n_kv=2, head_dim=64, d_ff=1024,
        vocab=8192,
    )
    cfg.validate()
    return cfg


def main(device="cuda", *, steps: int = STEPS, ckpt_dir: str,
         save_every: int = SAVE_EVERY, verbose: bool = True) -> dict:
    """Train ``steps`` steps (batch 8 x seq 128 of the ``arith`` stream),
    saving ``{"params", "opt"}`` under ``ckpt_dir`` after every
    ``save_every``-th step; at the full STEPS the final loss must be below
    MAX_FINAL_LOSS.  Returns ``{"losses", "n_params", "ms_per_step",
    "checkpoints", "params", "opt"}``."""
    say = print if verbose else (lambda *a, **k: None)
    cfg = config()
    params = init_params(cfg, 0, device)
    n_params = sum(p.numel() for p in flatten(params)[0])
    say(f"model: {n_params / 1e6:.1f}M params, {cfg.n_layers}L "
        f"d={cfg.d_model}")
    opt_cfg = AdamWConfig(lr=6e-4, warmup=20, decay_steps=STEPS,
                          weight_decay=0.01)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    pf = Prefetcher(SyntheticLM(cfg, seq=128, batch=8, pattern="arith"))
    losses, saved = [], []
    t0 = time.perf_counter()
    try:
        for _ in range(steps):
            s, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
            if s % 25 == 0 or s == steps - 1:
                say(f"step {s:4d} loss={losses[-1]:.4f} "
                    f"gnorm={float(m['gnorm']):.3f} "
                    f"({(time.perf_counter() - t0) / (s + 1) * 1e3:.0f} "
                    f"ms/step)")
            if (s + 1) % save_every == 0:
                saved.append(ckpt.save(ckpt_dir, s + 1,
                                       {"params": params, "opt": opt}))
    finally:
        pf.close()
    ms = (time.perf_counter() - t0) / steps * 1e3
    final = losses[-1]
    say(f"final loss {final:.4f} (init ~ln({cfg.vocab})="
        f"{math.log(cfg.vocab):.2f})")
    if steps >= STEPS and not final < MAX_FINAL_LOSS:
        raise RuntimeError(f"expected a large loss reduction on the "
                           f"arithmetic stream: final loss {final:.4f}")
    say(f"trained {steps} steps with periodic fingerprinted checkpoints")
    return {"losses": losses, "n_params": n_params, "ms_per_step": ms,
            "checkpoints": saved, "params": params, "opt": opt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "train_e2e_ck"))
    args = ap.parse_args()
    main(args.device, ckpt_dir=args.ckpt_dir)
