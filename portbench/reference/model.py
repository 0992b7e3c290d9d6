"""Plain PyTorch building blocks of the reference forward passes, and the
training loss over a family's ``logits``: Mamba2's layer (arXiv:2405.21060)
for the families built of it (``portbench/families/``).

Written from the paper, not from the program: the SSD is the paper's
chunked "minimal discrete" form (segment sums masked before the ``exp``,
a chunk-to-chunk recurrence through a decay matrix).  It runs in the dtype
of the parameters it is given (f32 for the check) and every product goes
through ``mm``, so the control can put a lower precision there.  Each
layer's activations are recomputed in the backward pass, so a long row
fits the card beside the reference's f32 state.  It imports nothing of the
program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["rms_norm", "ssd", "mamba2", "mamba_layer", "layer",
           "recomputed", "loss_of_rows"]


def _mm(a, b):
    return a @ b


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + scale)


def segsum(a):
    """(..., T) -> (..., T, T): sum of a[k+1..q] at [q, k] for q >= k,
    -inf above the diagonal (masked before any ``exp``)."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, -math.inf)


def ssd(X, a, B, C, chunk):
    """y_t = sum_{k<=t} (C_t . B_k) exp(a_{k+1} + ... + a_t) X_k, the
    discrete SSM h_t = exp(a_t) h_{t-1} + B_t X_t^T, y_t = h_t^T C_t.

    X (b, s, h, p) (the input already scaled by dt), a (b, s, h) (dt A),
    B, C (b, s, n): one group.  Returns (b, s, h, p)."""
    b, s, h, p = X.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    c = s // Q
    X = X.reshape(b, c, Q, h, p)
    a = a.reshape(b, c, Q, h).permute(0, 3, 1, 2)          # (b, h, c, Q)
    B = B.reshape(b, c, Q, n)
    C = C.reshape(b, c, Q, n)
    a_cs = torch.cumsum(a, dim=-1)

    # inside each chunk: a masked, decayed C.B^T against X
    L = torch.exp(segsum(a))                                # (b, h, c, Q, Q)
    CB = _mm(C, B.transpose(-1, -2))                        # (b, c, Q, Q)
    W = CB[:, None] * L                                     # (b, h, c, Q, Q)
    y_diag = _mm(W, X.permute(0, 3, 1, 2, 4))               # (b, h, c, Q, p)

    # each chunk's final state from its own inputs
    decay = torch.exp(a_cs[..., -1:] - a_cs)                # (b, h, c, Q)
    Xd = X.permute(0, 3, 1, 2, 4) * decay[..., None]        # (b, h, c, Q, p)
    states = _mm(B.transpose(-1, -2)[:, None], Xd)          # (b, h, c, n, p)

    # the state entering each chunk: a decay matrix over chunk boundaries
    zero = torch.zeros_like(states[:, :, :1])
    states = torch.cat([zero, states], dim=2)               # (b, h, c+1, n, p)
    Lc = torch.exp(segsum(F.pad(a_cs[..., -1], (1, 0))))    # (b, h, c+1, c+1)
    entering = torch.einsum("bhzc,bhcnp->bhznp", Lc, states)[:, :, :-1]

    # their contribution inside the chunk
    y_off = _mm(C[:, None], entering) * torch.exp(a_cs)[..., None]
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4)             # (b, c, Q, h, p)
    return y.reshape(b, s, h, p)


def _conv_silu(x, w, bias):
    """Causal depthwise conv over the sequence + SiLU.  x (b, s, ch), w (W,
    ch): out_t = sum_i w_i x_{t - W + 1 + i}."""
    W = w.shape[0]
    y = F.conv1d(F.pad(x.transpose(1, 2), (W - 1, 0)),
                 w.transpose(0, 1)[:, None, :], bias, groups=x.shape[-1])
    return F.silu(y.transpose(1, 2))


def mamba2(P, m, u, mm):
    d_in = m["ssm_expand"] * m["d_model"]
    p, n = m["ssm_headdim"], m["ssm_state"]
    h = d_in // p
    b, s, _ = u.shape
    zxbcdt = mm(u, P["in_proj"])
    z, xBC, dt = torch.split(zxbcdt, [d_in, d_in + 2 * n, h], dim=-1)
    xBC = _conv_silu(xBC, P["conv_w"], P["conv_b"])
    x, B, C = torch.split(xBC, [d_in, n, n], dim=-1)
    x = x.reshape(b, s, h, p)
    dt = F.softplus(dt + P["dt_bias"])
    A = -torch.exp(P["A_log"])
    y = ssd(x * dt[..., None], dt * A, B, C, m["ssm_chunk"])
    y = (y + P["D"][:, None] * x).reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), P["norm"], m["norm_eps"])
    return mm(y, P["out_proj"])


def layer(stack, idx):
    """The parameters of layer ``idx`` (a tuple into the stacked axes)."""
    return {k: (layer(v, idx) if isinstance(v, dict) else v[idx])
            for k, v in stack.items()}


def mamba_layer(P, m, x, mm):
    return x + mamba2(P["mamba"], m, rms_norm(x, P["ln"], m["norm_eps"]), mm)


def recomputed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass
    rather than kept, so that a whole f32 row of a long sequence fits."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def loss_of_rows(logits, params, m, tokens, mm=_mm):
    """Mean next-token cross entropy of (b, s + 1) tokens under a family's
    ``logits(params, m, tokens, mm)``."""
    lg = logits(params, m, tokens[:, :-1].long(), mm).float()
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
