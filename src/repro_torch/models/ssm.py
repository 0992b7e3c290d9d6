"""Mamba2 / SSD (state-space duality) block: the reference's
``repro/models/ssm.py`` over tensors.

Training and prefill run the chunked SSD algorithm (arXiv:2405.21060): a
quadratic, attention-like product inside chunks of ``cfg.ssm_chunk``
positions and a linear scan of the chunk states between them.  Decode is
the one-token recurrence over a (heads, dstate, headdim) state and a ring
of the depthwise conv's last W - 1 inputs.

The dtypes are the reference's: the projections and the conv run in the
compute dtype, and so does the conv ring; x, B, C, dt and the state S are
f32 (the SSD core, ``ssd``, runs in the dtype it is given).  The reference
has no Pallas kernel here; its four-operand einsums are written out as
batched matmuls over (batch, chunk, head) with the order of the products
fixed, so that no (b, c, q, k, h, p) tensor is ever formed.

One departure, in the backward pass only: the reference builds the decay
mask as ``where(tri, exp(rel), 0)``.  Above the diagonal ``rel`` is
positive and can pass 88.7, where f32 ``exp`` is inf; the forward drops
those entries, but the gradient of the ``where`` is then ``0 * inf``, NaN.
``_decay_mask`` takes the mask before the ``exp``,
``exp(where(tri, rel, -inf))``: the same forward bit for bit, and every
gradient finite.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist.act_sharding import constrain
from .layers import init_linear, init_norm, on_shards, rms_norm, split_on

__all__ = ["init_mamba2", "mamba2_forward", "mamba2_decode",
           "init_ssm_state", "ssd"]


def _dims(cfg):
    d_in = cfg.d_inner
    h = cfg.ssm_heads
    p = cfg.ssm_headdim
    ds = cfg.ssm_state
    conv_ch = d_in + 2 * ds  # x, B, C share the conv (n_groups = 1)
    return d_in, h, p, ds, conv_ch


def init_mamba2(gen, cfg, dtype, device, lead=()):
    """One Mamba2 block's parameters with the reference's leaves and
    draws: A = -exp(A_log) with exp(A_log) uniform in [1, 16), dt_bias the
    inverse softplus of a dt log-uniform in [1e-3, 1e-1), D one, a
    N(0, 0.01) conv; ``lead`` prefixes each shape (the stacked layer
    axes)."""
    lead = tuple(lead)
    d = cfg.d_model
    d_in, h, p, ds, conv_ch = _dims(cfg)
    proj_out = 2 * d_in + 2 * ds + h  # z, x, B, C, dt
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
    """x: (b, s, c); w: (W, c); left-padded causal depthwise conv + silu.
    The W shifted products are summed in order, as the reference's
    ``sum(...)`` sums them.  On a mesh it runs on each device's shard
    (``_conv_on_mesh``)."""
    if hasattr(x, "device_mesh"):
        return _conv_on_mesh(x, w, b)
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
    return on_shards(_causal_depthwise_conv, mesh,
                     ((x, x_pl, ()), (w, w_pl, batch), (b, b_pl, batch)),
                     x_pl)


def _decay_mask(cum):
    """L[i, j] = exp(cum_i - cum_j) for i >= j, else 0, from the
    within-chunk cumulative decay ``cum`` (..., Q): (..., Q, Q).  The mask
    is taken before the ``exp`` (module docstring)."""
    Q = cum.shape[-1]
    rel = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(rel.masked_fill(~tri, -math.inf))


def ssd(x, dt, A, B, C, chunk: int, initial_state=None):
    """The chunked SSD scan in the dtype of its inputs.

    x: (b, s, h, p), dt: (b, s, h), A: (h,), B, C: (b, s, ds) (one
    group); ``chunk`` divides s; ``initial_state`` (b, h, ds, p) or None
    for zeros.  Returns (y (b, s, h, p) without the D skip, the final state
    (b, h, ds, p)).  Each chunk state is kept as (ds, h, p), the layout
    the off-diagonal product reads."""
    b, s, h, p = x.shape
    ds = B.shape[-1]
    Q = chunk
    nc = s // Q
    xc = x.reshape(b, nc, Q, h, p)
    Bc = B.reshape(b, nc, Q, ds)
    Cc = C.reshape(b, nc, Q, ds)
    dtc = dt.reshape(b, nc, Q, h)
    cum = torch.cumsum((dt * A).reshape(b, nc, Q, h), dim=2)

    # within a chunk: y_diag[q] = sum_k (C_q . B_k) L[q, k] dt_k x_k, as one
    # (b, c, h, q, k) weight times x over k
    cum_h = cum.permute(0, 1, 3, 2)                       # (b, c, h, Q)
    scores = Cc @ Bc.transpose(-1, -2)                    # (b, c, q, k)
    M = scores[:, :, None] * _decay_mask(cum_h) * dtc.permute(0, 1, 3, 2)[
        :, :, :, None, :]                                 # (b, c, h, q, k)
    y_diag = (M @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: S_c = sum_k exp(cum_last - cum_k) dt_k B_k (x) x_k
    suffix = torch.exp(cum[:, :, -1:, :] - cum)          # (b, c, Q, h)
    xw = xc * (suffix * dtc)[..., None]
    S_c = (Bc.transpose(-1, -2) @ xw.reshape(b, nc, Q, h * p)).reshape(
        b, nc, ds, h, p)

    # between chunks: S_prev[c] = exp(total[c-1]) S_prev[c-1] + S_c[c-1]
    total = torch.exp(cum[:, :, -1, :])                   # (b, c, h)
    S = (x.new_zeros((b, ds, h, p)) if initial_state is None
         else initial_state.permute(0, 2, 1, 3))
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = S * total[:, c, None, :, None] + S_c[:, c]
    S_prevs = torch.stack(prevs, dim=1)                   # (b, c, ds, h, p)

    # from earlier chunks: y_off[q] = exp(cum_q) C_q . S_prev
    y_off = (Cc @ S_prevs.reshape(b, nc, ds, h * p)).reshape(
        b, nc, Q, h, p) * torch.exp(cum)[..., None]
    return (y_diag + y_off).reshape(b, s, h, p), S.permute(0, 2, 1, 3)


def _ssd_on_mesh(x, dt, A, B, C, D, chunk, initial_state):
    """``ssd`` of a heads-split x, its D skip and its flattening to (b, s,
    h*p), on each device's shard under ``local_map``: torch 2.11's DTensor
    refuses the batched products' flattening of (b, c, h) and the
    output's of (h, p) when the heads are split.  The batch and heads
    splits of x are kept and any other placement replicated (the sequence
    whole, for the scan between chunks); dt, A, D and a given state follow
    them, B and C the batch only.  Each shard runs the plain path on its
    (row, head) blocks; the gradients of B and C (over the heads' split)
    and of A and D (over the batch's) are partial sums on each shard,
    summed (``on_shards``).  Returns (y (b, s, h*p), the final state
    (b, h, ds, p))."""
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


def mamba2_forward(params, cfg, u, *, initial_state=None):
    """u: (b, s, d) -> (out (b, s, d), {"S", "conv"}).  s must be a multiple
    of min(cfg.ssm_chunk, s).  The state is what decode continues from:
    S (b, h, ds, p) f32 and the conv ring, the last W - 1 raw conv inputs
    (b, W - 1, conv_ch) in the compute dtype, zero-left-padded when the
    prompt is shorter."""
    dt_ = u.dtype
    b, s, d = u.shape
    d_in, h, p, ds, conv_ch = _dims(cfg)
    Q = min(cfg.ssm_chunk, s)
    if s % Q:
        raise ValueError("sequence must be a multiple of ssm_chunk")

    zxbcdt = u @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    xBC_raw = zxbcdt[..., d_in:2 * d_in + 2 * ds]   # x, B, C side by side
    dtraw = zxbcdt[..., 2 * d_in + 2 * ds:]
    xBC = _causal_depthwise_conv(xBC_raw, params["conv_w"].to(dt_),
                                 params["conv_b"].to(dt_))
    x, B, C = torch.split(xBC, [d_in, ds, ds], dim=-1)

    f32 = torch.float32
    x = constrain(x.reshape(b, s, h, p).to(f32), "batch", None, "heads", None)
    dt = _softplus(dtraw.to(f32) + params["dt_bias"])    # (b, s, h)
    A = -torch.exp(params["A_log"])                      # (h,)
    if split_on(x, 2):
        y, S_last = _ssd_on_mesh(x, dt, A, B.to(f32), C.to(f32),
                                 params["D"], Q, initial_state)
    else:
        y, S_last = ssd(x, dt, A, B.to(f32), C.to(f32), Q, initial_state)
        y = (y + params["D"][:, None] * x).reshape(b, s, d_in)

    # gated output norm + projection
    y = rms_norm((y * _silu(z.to(f32))).to(dt_), params["norm"],
                 cfg.norm_eps)
    y = constrain(y, "batch", None, "dinner")
    out = constrain(y @ params["out_proj"].to(dt_), "batch", None, None)
    W1 = cfg.ssm_conv - 1
    tail = xBC_raw[:, max(0, s - W1):].contiguous()
    if s < W1:
        tail = F.pad(tail, (0, 0, W1 - s, 0))
    return out, {"S": S_last, "conv": tail}


def init_ssm_state(cfg, batch, dtype=torch.float32, device="cuda"):
    _, h, p, ds, conv_ch = _dims(cfg)
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
    d_in, h, p, ds, conv_ch = _dims(cfg)

    zxbcdt = u @ params["in_proj"].to(dt_)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[:, 0, d_in:2 * d_in + 2 * ds]             # (b, conv_ch)
    dtraw = zxbcdt[:, 0, 2 * d_in + 2 * ds:]

    # conv ring: window = [conv_state, new]; the window's dot in f32, as a
    # contraction of compute-dtype operands accumulates
    f32 = torch.float32
    win = torch.cat([state["conv"], xBC[:, None, :]], dim=1)  # (b, W, c)
    w = params["conv_w"].to(dt_)
    conv = (win.to(f32) * w.to(f32)).sum(dim=1).to(dt_)
    conv_out = _silu(conv + params["conv_b"].to(dt_))
    x, B, C = torch.split(conv_out, [d_in, ds, ds], dim=-1)

    x = x.reshape(b, h, p).to(f32)
    B = B.to(f32)                                            # (b, ds)
    C = C.to(f32)
    dt = _softplus(dtraw.to(f32) + params["dt_bias"])       # (b, h)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)                                # (b, h)

    S = state["S"] * decay[..., None, None] + (
        B[:, None, :, None] * (dt[..., None] * x)[:, :, None, :])
    y = (C[:, None, None, :] @ S)[:, :, 0] + params["D"][:, None] * x
    y = y.reshape(b, 1, d_in)
    y = rms_norm((y * _silu(z.to(f32))).to(dt_), params["norm"],
                 cfg.norm_eps)
    out = y @ params["out_proj"].to(dt_)
    return out, {"S": S, "conv": win[:, 1:]}
