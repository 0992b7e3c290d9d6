"""Train a small LM with the paper's RNS-exact gradient aggregation and
check that its loss trajectory matches the plain fp32 step.

The gradients are quantized to fixed point, encoded into residue channels
(the codec_encode kernel on the card), summed per channel by one int32
all-reduce (an exact ring homomorphism) and decoded at the optimizer
boundary (the codec_decode kernel) — with sign and clip decisions available
through Algorithm-1 comparisons without reconstruction
(``repro_torch/dist/grad_codec.py``).

    PYTHONPATH=src python -m repro_torch.rns_gradient_training      # card
    PYTHONPATH=src python -m repro_torch.rns_gradient_training --device cpu
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from .configs import get_config
from .dist.grad_codec import GradCodec
from .launch.train import init_group, make_rns_dp_step
from .models import init_params
from .train.data import SyntheticLM
from .train.optimizer import AdamWConfig, adamw_init
from .train.train_step import make_train_step

__all__ = ["main", "STEPS", "MAX_DRIFT"]

STEPS = 45
MAX_DRIFT = 0.05


def main(device="cuda", *, verbose: bool = True) -> dict:
    """Train llama3.2-3b ``.smoke()`` for STEPS steps through the RNS codec
    and through the fp32 step from the same parameters and batches; raise
    unless every step's losses agree within MAX_DRIFT and the RNS run
    learned.  Returns ``{"l_rns", "l_fp", "drift"}``."""
    say = print if verbose else (lambda *a, **k: None)
    cfg = get_config("llama3.2-3b").smoke()
    opt_cfg = AdamWConfig(lr=1e-3, warmup=5, decay_steps=STEPS,
                          weight_decay=0.0)
    codec = GradCodec.make(world=8)
    say(f"codec: {codec.base.n}+1 channels of 15-bit moduli, "
        f"M ~ 2^{codec.base.M.bit_length()}, quant step 2^-{codec.frac_bits}")
    loader = SyntheticLM(cfg, seq=32, batch=8, pattern="arith")

    def run(step_fn):
        params = init_params(cfg, 0, device)
        opt = adamw_init(params)
        losses = []
        for s in range(STEPS):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in loader.batch_at(s).items()}
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
        return losses

    made_group = init_group(device)
    try:
        rns_step, _ = make_rns_dp_step(cfg, opt_cfg, codec)
        l_rns = run(rns_step)
    finally:
        if made_group:
            dist.destroy_process_group()
    l_fp = run(make_train_step(cfg, opt_cfg))
    say(f"{'step':>4} {'rns_loss':>9} {'fp32_loss':>9}")
    for i in range(0, STEPS, 4):
        say(f"{i:4d} {l_rns[i]:9.4f} {l_fp[i]:9.4f}")
    drift = max(abs(a - b) for a, b in zip(l_rns, l_fp))
    say(f"max |loss drift| over {STEPS} steps: {drift:.4f}")
    if not drift < MAX_DRIFT:
        raise RuntimeError(f"RNS aggregation diverged from fp32: drift "
                           f"{drift:.4f}")
    if not l_rns[-1] < l_rns[0] - 1.0:
        raise RuntimeError(f"did not learn: loss {l_rns[0]:.4f} -> "
                           f"{l_rns[-1]:.4f}")
    say("RNS-aggregated training matches fp32 and learns")
    return {"l_rns": l_rns, "l_fp": l_fp, "drift": drift}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
