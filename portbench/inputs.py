"""What a run feeds the program, made from ``--seed``: the parameter tree,
the token batches and the wire faults.

The parameters are laid out as ``repro_torch.models`` expects them; the
layout of each model family is ``param_spec`` of
``portbench/families/<family>.py`` (a Mamba2 layer's leaves are
``mamba_leaves``, here for any family built of them).  They are drawn on
the device from one ``torch.Generator`` in two large calls (one normal,
one uniform draw) and cut into leaves.  The token batches are
``SyntheticLM`` batches, a copy of the port's ``train/data.py`` generator:
(seed, step)-keyed numpy draws.  The reference is handed the same tensors.
Nothing here imports the program.
"""
from __future__ import annotations

import math
import random

import numpy as np
import torch

__all__ = ["mamba_leaves", "UNIFORM_DRAWS", "init_params", "flatten",
           "unflatten", "SyntheticLM", "batch_pool", "draw_faults"]

_DT_LO, _DT_HI = math.log(1e-3), math.log(1e-1)

# draws made from u ~ U[0, 1): a_log = log of U[1, 16); dt_bias = inverse
# softplus of a dt log-uniform in [1e-3, 1e-1) (Mamba2's initialisation)
UNIFORM_DRAWS = {
    "a_log": lambda u: torch.log(u * 15.0 + 1.0),
    "dt_bias": lambda u: torch.log(torch.expm1(torch.exp(
        u * (_DT_HI - _DT_LO) + _DT_LO))),
}


def mamba_leaves(m, lead):
    """``[(path, shape, draw), ...]`` of one Mamba2 layer (one B/C group),
    stacked over the leading axes ``lead``."""
    d, d_in = m["d_model"], m["ssm_expand"] * m["d_model"]
    h, ds = d_in // m["ssm_headdim"], m["ssm_state"]
    conv_ch = d_in + 2 * ds
    return [
        (("ln",), lead + (d,), "zeros"),
        (("mamba", "in_proj"), lead + (d, 2 * d_in + 2 * ds + h), "n0.02"),
        (("mamba", "conv_w"), lead + (m["ssm_conv"], conv_ch), "n0.1"),
        (("mamba", "conv_b"), lead + (conv_ch,), "zeros"),
        (("mamba", "A_log"), lead + (h,), "a_log"),
        (("mamba", "D"), lead + (h,), "ones"),
        (("mamba", "dt_bias"), lead + (h,), "dt_bias"),
        (("mamba", "norm"), lead + (d_in,), "zeros"),
        (("mamba", "out_proj"), lead + (d_in, d), "n0.02"),
    ]


def unflatten(named: dict) -> dict:
    """``{"a/b": t}`` -> ``{"a": {"b": t}}``."""
    tree: dict = {}
    for name, t in named.items():
        *up, last = name.split("/")
        node = tree
        for k in up:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def flatten(tree, prefix: str = "") -> dict:
    """``{"a": {"b": t}}`` -> ``{"a/b": t}``, keys sorted at each level."""
    out = {}
    for k in sorted(tree):
        v, name = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def init_params(family, m, seed: int, device) -> dict:
    """The parameter tree of ``m`` in f32 on ``device`` from ``seed``, laid
    out by ``family.param_spec``: a draw is "n<std>" (normal), "zeros",
    "ones" or a name of ``UNIFORM_DRAWS`` or of the family's own
    ``UNIFORM_DRAWS``.  One normal and one uniform draw from a generator
    on the device; each leaf a view of them (or zeros / ones)."""
    spec = sorted(family.param_spec(m), key=lambda e: e[0])
    uniform = {**UNIFORM_DRAWS, **getattr(family, "UNIFORM_DRAWS", {})}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    f32 = dict(dtype=torch.float32, device=device)
    n_norm = sum(math.prod(s) for _, s, k in spec if k.startswith("n"))
    n_unif = sum(math.prod(s) for _, s, k in spec if k in uniform)
    normal = torch.randn(n_norm, generator=gen, **f32)
    unif = torch.rand(n_unif, generator=gen, **f32)
    named, a, b = {}, 0, 0
    for path, shape, kind in spec:
        n = math.prod(shape)
        if kind.startswith("n"):
            t = normal[a:a + n].view(shape).mul_(float(kind[1:]))
            a += n
        elif kind in uniform:
            t = uniform[kind](unif[b:b + n].view(shape))
            b += n
        elif kind in ("zeros", "ones"):
            t = (torch.zeros if kind == "zeros" else torch.ones)(shape, **f32)
        else:
            raise ValueError(f"unknown draw {kind!r} of {'/'.join(path)}")
        named["/".join(path)] = t
    return unflatten(named)


class SyntheticLM:
    """The port's ``train.data.SyntheticLM`` ("random" pattern): tokens
    (batch, seq + 1) uniform over the vocabulary, drawn by numpy from
    ``(seed << 32) ^ step``."""

    def __init__(self, vocab: int, seq: int, batch: int, seed: int):
        self.vocab, self.seq, self.batch, self.seed = vocab, seq, batch, seed

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((int(self.seed) << 32) ^ step)
        return rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                            dtype=np.int32)


def batch_pool(vocab: int, traffic: dict, seed: int, device) -> torch.Tensor:
    """``traffic["pool"]`` distinct batches, (pool, batch, seq + 1) int32
    on ``device`` in one copy; step i of a run takes batch i % pool."""
    data = SyntheticLM(vocab, traffic["seq"], traffic["batch"], seed)
    host = np.stack([data.batch_at(i) for i in range(traffic["pool"])])
    return torch.from_numpy(host).to(device)


def draw_faults(seed: int, step: int, k: int, channels: tuple[int, ...],
                elements: int) -> list[tuple[int, int, int]]:
    """``k`` wire faults of step ``step``: (channel, element, offset) with
    distinct elements and an offset in [1, m_c) (the residue stays
    canonical and changes)."""
    rng = random.Random(f"{int(seed)}:{step}")
    out, used = [], set()
    while len(out) < k:
        e = rng.randrange(elements)
        if e in used:
            continue
        used.add(e)
        c = rng.randrange(len(channels))
        out.append((c, e, rng.randrange(1, channels[c])))
    return out
