"""AdamW with global-norm clipping over plain trees of tensors.

Trees are nested dicts, lists and tuples of tensors (``dist/_tree.py``),
walked in the reference's leaf order.  The update is elementwise and
returns new tensors; nothing is updated in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..dist import _tree

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000


def adamw_init(params, *, master: bool = False):
    """Zero f32 moments per parameter and an int32 step count on the
    parameters' device; ``master=True`` also keeps an f32 copy of the
    parameters (the mixed-precision layout when parameters are bf16)."""
    leaves, _ = _tree.flatten(params)
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    st = {
        "m": _tree.tree_map(zeros, params),
        "v": _tree.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if master:
        st["master"] = _tree.tree_map(lambda p: p.to(torch.float32), params)
    return st


def _schedule(cfg: AdamWConfig, step):
    s = step.to(torch.float32)
    warm = s / max(1.0, cfg.warmup)
    prog = torch.clamp(
        (s - cfg.warmup) / max(1.0, cfg.decay_steps - cfg.warmup), 0.0, 1.0
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup, warm, 0.1 + 0.9 * cos)


def global_norm(tree):
    leaves, _ = _tree.flatten(tree)
    return torch.sqrt(
        sum(torch.sum(torch.square(l.to(torch.float32))) for l in leaves)
    )


def adamw_update(cfg: AdamWConfig, params, grads, opt_state, *,
                 grad_decode=None):
    """One AdamW step: ``(new_params, new_state, gnorm)``.

    ``grad_decode``, when given, maps the raw ``grads`` argument to the
    parameter-shaped gradient tree before any use: the seam the RNS
    gradient codec plugs into, so the transport stays integer up to the
    update and the decode runs here, at the optimizer boundary."""
    if grad_decode is not None:
        grads = grad_decode(grads)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    masters = opt_state.get("master", params)  # f32 masters when present

    def upd(p, base, g, m, v):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1.0 - b1) * g
        v2 = b2 * v + (1.0 - b2) * g * g
        mh = m2 / bc1
        vh = v2 / bc2
        base32 = base.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * base32
        new_base = base32 - lr * delta
        return new_base.to(p.dtype), new_base, m2, v2

    leaves, spec = _tree.flatten(params)

    def leaves_of(tree):
        other, other_spec = _tree.flatten(tree)
        if other_spec != spec:
            raise ValueError("adamw_update: a tree's structure differs from "
                             "the parameters'")
        return other

    outs = [upd(*args) for args in zip(
        leaves, *(leaves_of(t) for t in (masters, grads, opt_state["m"],
                                          opt_state["v"])))]
    pick = lambda i: _tree.unflatten(spec, [o[i] for o in outs])
    new_state = {"m": pick(2), "v": pick(3), "step": step}
    if "master" in opt_state:
        new_state["master"] = pick(1)
    return pick(0), new_state, gnorm
