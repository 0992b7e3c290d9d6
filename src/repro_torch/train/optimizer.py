"""AdamW with global-norm clipping over plain trees of tensors.

Trees are nested dicts, lists and tuples of tensors (``dist/_tree.py``),
walked in the reference's leaf order.  The update is elementwise and
returns new tensors; its inputs are not written to.  Given a dead buffer
(``out``), it writes the new state into that buffer's bytes instead of
fresh memory.
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


def _carve(buf, layout):
    """Views of the bytes of the contiguous tensor ``buf``, one per
    ``(shape, dtype)`` of ``layout``, each from a ``_ALIGN``-byte boundary;
    None when ``buf`` is too small or not contiguous."""
    if not buf.is_contiguous():
        return None
    raw = buf.reshape(-1).view(torch.uint8)
    views, off = [], 0
    for shape, dtype in layout:
        n = math.prod(shape) * dtype.itemsize
        if off + n > raw.numel():
            return None
        views.append(raw[off:off + n].view(dtype).view(shape))
        off += -(-n // _ALIGN) * _ALIGN
    return views


_ALIGN = 512   # the CUDA caching allocator's own block alignment


def adamw_update(cfg: AdamWConfig, params, grads, opt_state, *,
                 grad_decode=None, out=None):
    """One AdamW step: ``(new_params, new_state, gnorm)``.

    ``grad_decode``, when given, maps the raw ``grads`` argument to the
    parameter-shaped gradient tree before any use: the seam the RNS
    gradient codec plugs into, so the transport stays integer up to the
    update and the decode runs here, at the optimizer boundary.

    ``out``, when given, is a contiguous tensor that nothing reads any
    more (the decoded wire of the codec step): the new parameters, masters
    and moments are views of its bytes, so a step takes no fresh memory
    for them and the caller's old state stays as it was.  Where they do
    not fit, fresh tensors are made.  Either way the values are the same
    bit for bit, from the same kernels."""
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

    def upd(p, base, g, m, v, dst):
        """The new (param, f32 base, m, v); ``dst`` holds their tensors
        or Nones, the f32 base doubling as scratch before it is written."""
        p_out, base_out, m_out, v_out = dst
        g = g.to(torch.float32) * scale
        m2 = torch.mul(m, b1, out=m_out).add_((1.0 - b1) * g)
        v2 = torch.mul(v, b2, out=v_out).add_(((1.0 - b2) * g).mul_(g))
        del g   # one leaf-sized temporary at a time from here
        base32 = base.to(torch.float32)
        delta = m2 / bc1
        delta /= torch.div(v2, bc2, out=base_out).sqrt_().add_(cfg.eps)
        delta += torch.mul(base32, cfg.weight_decay, out=base_out)
        new_base = torch.sub(base32, delta.mul_(lr), out=base_out)
        if p_out is None:
            p_out = new_base.to(p.dtype)
        elif p_out is not new_base:
            p_out.copy_(new_base)
        return p_out, new_base, m2, v2

    leaves, spec = _tree.flatten(params)

    def leaves_of(tree):
        other, other_spec = _tree.flatten(tree)
        if other_spec != spec:
            raise ValueError("adamw_update: a tree's structure differs from "
                             "the parameters'")
        return other

    dsts = [(None,) * 4] * len(leaves)
    master = "master" in opt_state
    f32 = torch.float32
    views = None if out is None else _carve(out, [
        lay for p in leaves for lay in
        [(p.shape, p.dtype)] + [(p.shape, f32)] * (3 if master else 2)])
    if views is not None:
        k = 4 if master else 3
        dsts = []
        for i, p in enumerate(leaves):
            mine = views[k * i:k * (i + 1)]
            p_out, base_out = mine[0], mine[1] if master else None
            if p.dtype == f32:   # the new f32 base is the new parameter
                p_out = base_out = base_out if master else p_out
            dsts.append((p_out, base_out, mine[-2], mine[-1]))
    outs = [upd(*args) for args in zip(
        leaves, *(leaves_of(t) for t in (masters, grads, opt_state["m"],
                                          opt_state["v"])), dsts)]
    pick = lambda i: _tree.unflatten(spec, [o[i] for o in outs])
    new_state = {"m": pick(2), "v": pick(3), "step": step}
    if master:
        new_state["master"] = pick(1)
    return pick(0), new_state, gnorm
