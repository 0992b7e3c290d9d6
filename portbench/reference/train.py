"""Plain reference of a training step: the loss and gradients of
``model.loss_of_rows`` under a family's reference ``logits``, by autograd
(a batch row at a time, their mean), the gradient codec's fixed-point
rounding where the step has a codec, and AdamW with global-norm clipping
and a warmup-then-cosine learning rate.

The codec's exact sum over one rank gives back each gradient rounded to
a multiple of 2**-frac_bits and clipped to the codec's range; the range
comes from the codec's moduli, which ``rrns.codec_moduli`` works out
again.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

from ..inputs import unflatten
from . import model as ref_model
from .rrns import codec_moduli

__all__ = ["reference_steps", "lr_at", "quantize"]


def lr_at(opt: dict, step: int) -> float:
    """Learning rate of step ``step`` (1-based): linear warmup, then a
    cosine from lr down to a tenth of it over ``decay_steps``."""
    s = float(step)
    if s < opt["warmup"]:
        return opt["lr"] * s / max(1.0, opt["warmup"])
    prog = min(max((s - opt["warmup"]) / max(1.0, opt["decay_steps"]
                                               - opt["warmup"]), 0.0), 1.0)
    return opt["lr"] * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def quantize(g, codec: dict):
    """The codec's round trip over one rank: round(g 2**f) clipped to
    +-qmax, times 2**-f, qmax = (M - 1) // (2 world) for the product M of
    the base moduli."""
    base, _ = codec_moduli(codec)
    qmax = float((math.prod(base) - 1) // (2 * codec["world"]))
    f = float(2 ** codec["frac_bits"])
    q = torch.round(g.double() * f).clamp(-qmax, qmax)
    return (q / f).to(g.dtype)


def _grads(logits, params, m, tokens, mm):
    """(mean loss, gradient dict) of a (b, s + 1) batch, a row at a time."""
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    tree = unflatten(dict(zip(names, leaves)))
    b = tokens.shape[0]
    total, acc = 0.0, [torch.zeros_like(p) for p in leaves]
    for r in range(b):
        loss = ref_model.loss_of_rows(logits, tree, m, tokens[r:r + 1], mm)
        gs = torch.autograd.grad(loss / b, leaves)
        for a, g in zip(acc, gs):
            a.add_(g)
        total += float(loss.detach()) / b
    return total, dict(zip(names, acc))


def reference_steps(logits, m, params0: dict, batches, opt: dict,
                    codec=None, mm=None, on_step=None):
    """Run ``len(batches)`` AdamW steps of the model ``m`` (a family's
    ``logits``) from ``params0`` (a flat name -> tensor dict, copied).
    ``on_step(t, loss, grads, params)`` sees each step's loss, the
    gradient as the optimizer takes it (after the codec's rounding, before
    clipping) and the parameters after the update."""
    mm = mm or ref_model._mm
    params = {k: v.detach().clone() for k, v in params0.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    for t, tokens in enumerate(batches, start=1):
        loss, grads = _grads(logits, params, m, tokens, mm)
        if codec is not None:
            grads = {k: quantize(g, codec) for k, g in grads.items()}
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                              for g in grads.values()))
        scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
        lr = lr_at(opt, t)
        bc1, bc2 = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
        for k, p in params.items():
            g = grads[k] * scale
            mom[k] = opt["b1"] * mom[k] + (1.0 - opt["b1"]) * g
            vel[k] = opt["b2"] * vel[k] + (1.0 - opt["b2"]) * g * g
            upd = (mom[k] / bc1) / (torch.sqrt(vel[k] / bc2) + opt["eps"])
            params[k] = p - lr * (upd + opt["weight_decay"] * p)
        if on_step is not None:
            on_step(t, loss, grads, params)
        del grads
    return params
