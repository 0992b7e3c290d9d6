"""Mamba2 / SSD (state-space duality) block: the reference's
``repro/models/ssm.py`` over tensors.

Training and prefill run the chunked SSD algorithm (arXiv:2405.21060): a
quadratic, attention-like product inside chunks of ``cfg.ssm_chunk``
positions and a linear scan of the chunk states between them.  Decode is
the one-token recurrence over a (heads, dstate, headdim) state and a ring
of the depthwise conv's last W - 1 inputs.

The dtypes are the reference's: the projections and the conv run in the
compute dtype, and so does the conv ring; x, B, C, dt and the state S are
f32 (the SSD core, ``ssd``, runs in the dtype it is given on the CPU, in
f32 on the card).  The reference has no Pallas kernel here.  On the card
``ssd`` runs the port's own CUDA kernels, forward and backward
(``kernels.ops.ssd_op``): no (b, c, h, Q, Q) weight in device memory, and
one kernel for the scan between chunks.  On the CPU it runs their plain
version beside them, ``kernels.ssd.ssd_plain``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..dist.act_sharding import constrain
from ..kernels.ops import ssd_op
from ..spans import traced
from .layers import init_linear, init_norm, on_shards, rms_norm, split_on

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode",
           "init_ssm_state", "ssd"]


def _dims(cfg):
    """(d_inner, heads, headdim, state, conv channels, B/C groups)."""
    d_in = cfg.d_inner
    h = cfg.ssm_heads
    p = cfg.ssm_headdim
    ds = cfg.ssm_state
    G = cfg.ssm_groups
    conv_ch = d_in + 2 * G * ds  # x and each group's B, C share the conv
    return d_in, h, p, ds, conv_ch, G


def init_mamba2(gen, cfg, dtype, device, lead=()):
    """One Mamba2 block's parameters with the reference's leaves and
    draws: A = -exp(A_log) with exp(A_log) uniform in [1, 16), dt_bias the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1), D one, a
    N(0, 0.01) conv; ``lead`` prefixes each shape (the stacked layer
    axes)."""
    lead = tuple(lead)
    d = cfg.d_model
    d_in, h, p, ds, conv_ch, G = _dims(cfg)
    proj_out = 2 * d_in + 2 * G * ds + h  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(lo, hi):
        u = torch.rand(lead + (h,), generator=gen, **f32)
        return u * (hi - lo) + lo

    return {
        "in_proj": init_linear(gen, lead + (d, proj_out), dtype, device),
        "conv_w": init_linear(gen, lead + (cfg.ssm_conv, conv_ch), dtype,
                              device, scale=0.1),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones(lead + (h,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.exp(
            uniform(math.log(1e-3), math.log(1e-1))))),
        "norm": init_norm(lead + (d_in,), dtype, device),
        "out_proj": init_linear(gen, lead + (d_in, d), dtype, device),
    }


def _softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu(x):
    """``jax.nn.silu``'s form, ``x * sigmoid(x)``: in bf16 the sigmoid
    rounds before the product, as XLA rounds it."""
    return x * torch.sigmoid(x)


def _causal_depthwise_conv(x, w, b):
    """x: (b, s, c); w: (W, c); left-padded causal depthwise conv + silu
    (``_conv``).  On a mesh it runs on each device's shard
    (``_conv_on_mesh``)."""
    if hasattr(x, "device_mesh"):
        return _conv_on_mesh(x, w, b)
    return _conv(x, w, b)


@traced("ssm.conv")
def _conv(x, w, b):
    """The conv of plain tensors: the W shifted products summed in order,
    as the reference's ``sum(...)`` sums them."""
    W, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + s] * w[i]
    return _silu(out + b)


def _conv_on_mesh(x, w, b):
    """The conv of a DTensor x on each device's shard under ``local_map``:
    x keeps its batch and channel splits and is otherwise gathered whole
    (the sequence whole on each shard, as the conv reads W - 1 positions
    back), w and b follow the channels, their gradients summed over the
    batch's split (``on_shards``).  torch 2.11's DTensor cannot plan
    the pad of a DTensor (an ``IndexError`` in its redistribution
    planner); on each shard the pad is a plain tensor's."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    x_pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in x.placements]
    w_pl = [Shard(1) if p.is_shard(2) else Replicate() for p in x_pl]
    b_pl = [Shard(0) if p.is_shard(2) else Replicate() for p in x_pl]
    batch = [i for i, p in enumerate(x_pl) if p.is_shard(0)]
    return on_shards(_conv, mesh,
                     ((x, x_pl, ()), (w, w_pl, batch), (b, b_pl, batch)),
                     x_pl)


@traced("ssm.ssd")
def ssd(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked SSD scan.

    x: (b, s, h, p), dt: (b, s, h), A: (h,), B, C: (b, s, ds) (one
    group) or (b, s, G, ds) (G groups, group g read by heads g h/G ..
    (g + 1) h/G - 1); ``chunk`` divides s; ``initial_state`` (b, h, ds, p)
    or None for zeros.  Returns (y (b, s, h, p) without the D skip, the
    final state (b, h, ds, p)).  ``kernels.ops.ssd_op`` runs it: a CUDA
    tensor takes the kernels (f32, or it raises), a CPU one
    ``kernels.ssd.ssd_plain`` in the dtype of its inputs."""
    return ssd_op(x, dt, A, B, C, chunk, initial_state)


def _ssd_on_mesh(x, dt, A, B, C, D, chunk, initial_state):
    """``ssd`` of a DTensor x, its D skip and its flattening to (b, s,
    h*p), on each device's shard under ``local_map``: the kernels take
    plain tensors, and torch 2.11's DTensor refuses the plain version's
    flattening of (b, c, h) and the output's of (h, p) when the heads are
    split.  The batch
    and heads splits of x are kept and any other placement replicated (the
    sequence whole, for the scan between chunks); dt, A, D and a given
    state follow them, B and C the batch only.  Each shard runs ``ssd`` on
    its (row, head) blocks; the gradients of B and C (over the heads'
    split) and of A and D (over the batch's) are partial sums on each
    shard, summed (``on_shards``).  Returns (y (b, s, h*p), the final
    state (b, h, ds, p))."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    x_pl = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
            for p in x.placements]
    heads = [Shard(0) if p.is_shard(2) else Replicate() for p in x_pl]
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x_pl]
    state = [Shard(1) if p.is_shard(2) else p for p in x_pl]
    by_heads = [i for i, p in enumerate(x_pl) if p.is_shard(2)]
    by_rows = [i for i, p in enumerate(x_pl) if p.is_shard(0)]

    args = [(x, x_pl, ()), (dt, x_pl, ()), (A, heads, by_rows),
            (B, rows, by_heads), (C, rows, by_heads), (D, heads, by_rows)]
    if initial_state is not None:
        args.append((initial_state, state, ()))

    def run(xl, dtl, Al, Bl, Cl, Dl, *init):
        b, s, h, p = xl.shape
        y, S = ssd(xl, dtl, Al, Bl, Cl, chunk, init[0] if init else None)
        return (y + Dl[:, None] * xl).reshape(b, s, h * p), S

    out = [Shard(2) if p.is_shard(2) else p for p in x_pl]
    return on_shards(run, mesh, args, (out, state))


@traced("ssm.mixer")
def mamba2_forward(params, cfg, u, *, initial_state=None):
    """u: (b, s, d) -> (out (b, s, d), {"S", "conv"}).  s must be a multiple
    of min(cfg.ssm_chunk, s).  The state is what decode continues from:
    S (b, h, ds, p) f32 and the conv ring, the last W - 1 raw conv inputs
    (b, W - 1, conv_ch) in the compute dtype, zero-left-padded when the
    prompt is shorter."""
    dt_ = u.dtype
    b, s, d = u.shape
    d_in, h, p, ds, conv_ch, G = _dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    if s % Q:
        raise ValueError("sequence must be a multiple of ssm_chunk")

    zxbcdt = u @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    xBC_raw = zxbcdt[..., d_in:d_in + conv_ch]   # x, B, C side by side
    dtraw = zxbcdt[..., d_in + conv_ch:]
    xBC = _causal_depthwise_conv(xBC_raw, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    x, B, C = torch.split(xBC, [d_in, G * ds, G * ds], dim=-1)

    f32 = torch.float32
    x = constrain(x.reshape(b, s, h, p).to(f32), "batch", None, "heads", None)
    dt = _softplus(dtraw.to(f32) + params["dt_bias"])    # (b, s, h)
    A = -torch.exp(params["A_log"])                      # (h,)
    B, C = B.to(f32), C.to(f32)
    if G > 1:                                            # (b, s, G, ds)
        B, C = B.unflatten(-1, (G, ds)), C.unflatten(-1, (G, ds))
    if isinstance(x, DTensor):
        if G > 1 and split_on(x, 2):
            raise ValueError(f"ssm_groups={G}: the SSD on a mesh splits "
                             "heads, which groups of B and C do not follow")
        y, S_last = _ssd_on_mesh(x, dt, A, B, C, params["D"], Q,
                                 initial_state)
    else:
        y, S_last = ssd(x, dt, A, B, C, Q, initial_state)
        y = (y + params["D"][:, None] * x).reshape(b, s, d_in)

    # gated output norm (over each group's d_inner / G channels) + projection
    y = _gated_norm((y * _silu(z.to(f32))).to(dt_), params["norm"], G,
                    cfg.norm_eps)
    y = constrain(y, "batch", None, "dinner")
    out = constrain(y @ params["out_proj"].to(dt_), "batch", None, None)
    W1 = cfg.ssm_conv - 1
    tail = xBC_raw[:, max(0, s - W1):].contiguous()
    if s < W1:
        tail = F.pad(tail, (0, 0, W1 - s, 0))
    return out, {"S": S_last, "conv": tail}


def _gated_norm(y, scale, G: int, eps: float):
    """``rms_norm`` of the gated output over each of the G groups' d_inner
    / G channels (Mamba2's grouped RMSNormGated); one group: over all."""
    if G == 1:
        return rms_norm(y, scale, eps)
    return rms_norm(y.unflatten(-1, (G, -1)), scale.view(G, -1),
                    eps).flatten(-2)


def _to_heads(B, G: int, h: int):
    """A decode step's (b, G ds) B or C as (b, 1, ds) for one group, else
    each group's row repeated for its h / G heads, (b, h, ds)."""
    b = B.shape[0]
    if G == 1:
        return B[:, None]
    return B.view(b, G, 1, -1).expand(b, G, h // G, -1).reshape(b, h, -1)


def init_ssm_state(cfg, batch, dtype=torch.float32, device="cuda"):
    _, h, p, ds, conv_ch, _ = _dims(cfg)
    return {
        "S": torch.zeros((batch, h, ds, p), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba2_decode(params, cfg, u, state):
    """One-token step.  u: (b, 1, d); state: {"S", "conv"}.  Returns
    (y, the new state)."""
    dt_ = u.dtype
    b = u.shape[0]
    d_in, h, p, ds, conv_ch, G = _dims(cfg)

    zxbcdt = u @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[:, 0, d_in:d_in + conv_ch]                # (b, conv_ch)
    dtraw = zxbcdt[:, 0, d_in + conv_ch:]

    # conv ring: window = [conv_state, new]; the window's dot in f32, as a
    # contraction of compute-dtype operands accumulates
    f32 = torch.float32
    win = torch.cat([state["conv"], xBC[:, None, :]], dim=1)  # (b, W, c)
    w = params["conv_w"].to(dt_)
    conv = (win.to(f32) * w.to(f32)).sum(dim=1).to(dt_)
    conv_out = _silu(conv + params["conv_b"].to(dt_))
    x, B, C = torch.split(conv_out, [d_in, G * ds, G * ds], dim=-1)

    x = x.reshape(b, h, p).to(f32)
    B = _to_heads(B.to(f32), G, h)                           # (b, 1 | h, ds)
    C = _to_heads(C.to(f32), G, h)
    dt = _softplus(dtraw.to(f32) + params["dt_bias"])       # (b, h)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                # (b, h)

    S = state["S"] * decay[..., None, None] + (
        B[:, :, :, None] * (dt[..., None] * x)[:, :, None, :])
    y = (C[:, :, None, :] @ S)[:, :, 0] + params["D"][:, None] * x
    y = y.reshape(b, 1, d_in)
    y = _gated_norm((y * _silu(z.to(f32))).to(dt_), params["norm"], G,
                    cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    return out, {"S": S, "conv": win[:, 1:]}
