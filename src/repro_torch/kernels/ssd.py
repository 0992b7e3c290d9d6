"""The SSD core of Mamba2 (arXiv:2405.21060): the CUDA kernels
``csrc/ssd.cu``, forward and backward, their plain torch version
``ssd_plain`` with its mirrors stage by stage, and the
``torch.autograd.Function`` that runs the kernels.

The reference package has no kernel here: its ``ssd`` is plain jnp, and
``ssd_plain`` keeps that body for CPU tensors, its four-operand einsums
written out as batched matmuls over (batch, chunk, head) with the order of
the products fixed, so that no (b, c, q, k, h, p) tensor is ever formed.
``models/ssm.py::ssd`` calls ``ops.ssd_op``, which on the card runs
``SSDFunction``: the forward's four launches (the chunk states and the
within-chunk cumulative decay, the scan between chunks, C B^T a group, the
chunk scan) and the backward's six (the state gradients, their reverse
scan, dCB over a group's heads, dx, dB and dC over a group's heads, dcum
-> ddt, dA).  No (Q x Q)-a-head tensor is
written to device memory (``csrc/ssd.cu``).

One departure from the reference, in the backward pass only: the
reference builds the decay mask as ``where(tri, exp(rel), 0)``.  Above the
diagonal ``rel`` is positive and can pass 88.7, where f32 ``exp`` is inf;
the forward drops those entries, but the gradient of the ``where`` is then
``0 * inf``, NaN.  ``_decay_mask`` takes the mask before the ``exp``,
``exp(where(tri, rel, -inf))``: the same forward bit for bit, and every
gradient finite.  The kernels take every ``exp`` of a non-positive
difference.

Contract (``models/ssm.py::ssd``): x (b, s, h, p), dt (b, s, h), A (h,),
B, C (b, s, G, ds), ``chunk`` Q dividing s, the initial state (b, h, ds, p)
or None; returns y (b, s, h, p) without the D skip and the final state.
The kernels take f32 contiguous operands with Q <= 256, p <= 64, p and ds
multiples of 4, G dividing h; ``check_operands`` raises on anything else.
``ops.ssd_op`` applies ``SSDFunction`` to CUDA tensors only; a CPU tensor
runs ``ssd_plain``.  The plain mirrors are the oracles: the
tests hold them against ``torch.autograd`` of ``ssd_plain``, and the
kernels against them on the card (the tests and ``chip_smoke.py``).

The forward saves the inputs and three buffers, held by autograd until the
backward (under remat only during the layer's own backward): ``cum`` (b,
c, h, Q) the within-chunk cumulative decay, ``S`` (b, c, h, ds, p) the
state entering each chunk, ``CB`` (b, c, G, Q, Q) C B^T on and below the
diagonal.  The kernels pad Q to the 64 tile (QT) in ``cum`` and ``CB``,
and keep a fourth, ``yoff`` (b, s, h, p), y's term from the earlier
chunks, whose product with dy is dcum's term from them.
"""
from __future__ import annotations

import functools
import math

import torch

from . import build

__all__ = ["SSDFunction", "ssd_plain", "ssd_forward_plain",
           "ssd_backward_plain", "ssd_kernel_forward", "ssd_kernel_backward",
           "check_operands", "dense", "FORWARD_LAUNCHES", "BACKWARD_LAUNCHES",
           "MAX_CHUNK", "MAX_HEADDIM"]

FORWARD_LAUNCHES = 4
BACKWARD_LAUNCHES = 6
MAX_CHUNK = 256      # csrc/ssd.cu kMaxQ
MAX_HEADDIM = 64     # one 64-wide tile of p
_TILE = 64


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _dims(x, B, Q):
    b, s, h, p = x.shape
    G, ds = B.shape[2], B.shape[3]
    return b, s, h, p, G, ds, s // Q


# ------------------------------------------- plain version, plain mirrors
def _decay_mask(cum):
    """L[i, j] = exp(cum_i - cum_j) for i >= j, else 0, from the
    within-chunk cumulative decay ``cum`` (..., Q): (..., Q, Q).  The mask
    is taken before the ``exp`` (module docstring)."""
    Q = cum.shape[-1]
    rel = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(rel.masked_fill(~tri, -math.inf))


def ssd_plain(x, dt, A, B, C, chunk: int, initial_state=None):
    """``models.ssm.ssd`` in plain torch: the body a CPU tensor runs.  B
    and C of G groups are read by a broadcast view.  Each chunk state is
    kept as (b G, ds, h/G, p), the layout the off-diagonal product reads.
    One group runs as a group axis of size one, folded into the batch
    where the chunk states are stacked: the same products and kernels as
    a call without the axis."""
    b, s, h, p = x.shape
    if B.ndim == 3:
        B, C = B[:, :, None], C[:, :, None]
    G, ds = B.shape[2], B.shape[3]
    hg = h // G
    Q = chunk
    nc = s // Q
    xc = x.reshape(b, nc, Q, h, p)
    Bc = B.reshape(b, nc, Q, G, ds).transpose(2, 3)       # (b, c, G, Q, ds)
    Cc = C.reshape(b, nc, Q, G, ds).transpose(2, 3)
    dtc = dt.reshape(b, nc, Q, h)
    cum = torch.cumsum((dt * A).reshape(b, nc, Q, h), dim=2)

    # within a chunk: y_diag[q] = sum_k (C_q . B_k) L[q, k] dt_k x_k, as one
    # (b, c, h, q, k) weight times x over k
    cum_h = cum.permute(0, 1, 3, 2)                       # (b, c, h, Q)
    scores = Cc @ Bc.transpose(-1, -2)                    # (b, c, G, q, k)
    M = (scores[:, :, :, None] * _decay_mask(cum_h).view(b, nc, G, hg, Q, Q)
         * dtc.permute(0, 1, 3, 2).reshape(b, nc, G, hg, 1, Q)).reshape(
             b, nc, h, Q, Q)                              # (b, c, h, q, k)
    y_diag = (M @ xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states: S_c = sum_k exp(cum_last - cum_k) dt_k B_k (x) x_k, one
    # (ds, h/G, p) state a (row, group), (b G, c, ds, h/G, p)
    suffix = torch.exp(cum[:, :, -1:, :] - cum)          # (b, c, Q, h)
    xw = xc * (suffix * dtc)[..., None]
    S_c = (Bc.transpose(-1, -2) @ xw.reshape(b, nc, Q, G, hg * p).transpose(
        2, 3)).transpose(1, 2).reshape(b * G, nc, ds, hg, p)

    # between chunks: S_prev[c] = exp(total[c-1]) S_prev[c-1] + S_c[c-1]
    total = torch.exp(cum[:, :, -1, :])                   # (b, c, h)
    S = (x.new_zeros((b * G, ds, hg, p)) if initial_state is None
         else initial_state.view(b, G, hg, ds, p).transpose(2, 3).reshape(
             b * G, ds, hg, p))
    prevs = []
    for c in range(nc):
        prevs.append(S)
        S = S * total[:, c].view(b, G, hg).reshape(b * G, 1, hg, 1) + S_c[:, c]
    S_prevs = torch.stack(prevs, dim=1)                   # (b G, c, ds, hg, p)

    # from earlier chunks: y_off[q] = exp(cum_q) C_q . S_prev
    y_off = (Cc @ S_prevs.view(b, G, nc, ds, hg * p).transpose(1, 2)
             ).transpose(2, 3).reshape(b, nc, Q, h, p) * torch.exp(cum)[
                 ..., None]
    return ((y_diag + y_off).reshape(b, s, h, p),
            S.view(b, G, ds, hg, p).transpose(2, 3).reshape(b, h, ds, p))


def _heads(t, hg: int):
    """(b, c, Q, G, n) -> each group's rows for its hg heads: (b, c, Q, h,
    n)."""
    return t.repeat_interleave(hg, dim=3)


def ssd_forward_plain(x, dt, A, B, C, Q: int, initial_state=None):
    """The kernels' forward in plain torch, stage by stage: (y, the final
    state, (cum, S, CB)).  ``cum`` is cumsum(dt A) within each chunk, (b,
    c, h, Q); the chunk states S_c = B^T (w x), w_k = exp(cum_last - cum_k)
    dt_k; ``S`` the state entering each chunk, S = exp(cum_last) S + S_c
    chunk by chunk, (b, c, h, ds, p); ``CB`` = C B^T a group, (b, c, G, Q,
    Q); y = exp(cum_q) C_q S + sum_{k <= q} CB[q, k] exp(cum_q - cum_k)
    dt_k x_k."""
    b, s, h, p, G, ds, nc = _dims(x, B, Q)
    hg = h // G
    xc = x.reshape(b, nc, Q, h, p)
    Bc, Cc = B.reshape(b, nc, Q, G, ds), C.reshape(b, nc, Q, G, ds)
    Bh, Ch = _heads(Bc, hg), _heads(Cc, hg)
    dtk = dt.reshape(b, nc, Q, h).permute(0, 1, 3, 2)          # (b, c, h, Q)
    cum = torch.cumsum(dtk * A[:, None], dim=-1)
    last = cum[..., -1:]
    w = torch.exp(last - cum) * dtk
    S_c = torch.einsum("bcqhn,bcqhp->bchnp", Bh,
                       xc * w.permute(0, 1, 3, 2)[..., None])
    T = torch.exp(last[..., 0])                                # (b, c, h)
    S_run = (x.new_zeros((b, h, ds, p)) if initial_state is None
             else initial_state)
    prevs = []
    for c in range(nc):
        prevs.append(S_run)
        S_run = S_run * T[:, c, :, None, None] + S_c[:, c]
    S = torch.stack(prevs, dim=1)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    W = (CB.repeat_interleave(hg, dim=2) * _decay_mask(cum)) * dtk[
        ..., None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", W, xc) + torch.einsum(
        "bcqhn,bchnp->bcqhp", Ch, S) * torch.exp(cum).permute(
            0, 1, 3, 2)[..., None]
    return y.reshape(b, s, h, p), S_run, (cum, S, CB)


def ssd_backward_plain(x, dt, A, B, C, cum, S, CB, dy, dfinal, *,
                       want_initial: bool = False):
    """The kernels' backward in plain torch, stage by stage, from the
    forward's ``cum``, ``S`` and ``CB`` (``ssd_forward_plain``) and the
    gradients of y and of the final state (``dfinal`` None: zeros).
    Returns (dx, ddt, dA, dB, dC, the initial state's gradient or None).

    1. dS = C^T (exp(cum) dy), each chunk's gradient of the state entering
       it from its own outputs;
    2. the reverse scan: g, the gradient of the state leaving chunk c, is
       the gradient of its chunk state S_c (dS_c); dT_c = <g, S_c entering>;
       g = exp(cum_last) g + dS; the initial state's gradient is the last g;
    3. the diagonal: dM = dy_q . x_k; v = dM CB L; cs_k = sum_q v, rs_q =
       sum_k v dt_k; dCB = sum over a group's heads of dM L dt_k;
    4. dx_k = w_k (B_k dS_c) + sum_{q >= k} W[q, k] dy_q, dw_k = x_k . (B_k
       dS_c);
    5. dC = sum_heads exp(cum_q) dy_q S^T + dCB B, dB = sum_heads w_k x_k
       dS_c^T + dCB^T C, and off_q = exp(cum_q) C_q . (dy_q S^T);
    6. dcum = rs - dt cs + off - dw w, plus sum_k dw_k w_k + dT exp(cum_last)
       at the last position; da its reverse cumsum within the chunk; ddt =
       cs + dw exp(cum_last - cum) + A da, dA = sum dt da."""
    b, s, h, p, G, ds, nc = _dims(x, B, cum.shape[-1])
    Q, hg = cum.shape[-1], h // G
    xc, dyc = x.reshape(b, nc, Q, h, p), dy.reshape(b, nc, Q, h, p)
    Bc, Cc = B.reshape(b, nc, Q, G, ds), C.reshape(b, nc, Q, G, ds)
    Bh, Ch = _heads(Bc, hg), _heads(Cc, hg)
    dtk = dt.reshape(b, nc, Q, h).permute(0, 1, 3, 2)
    last = cum[..., -1:]
    e, E = torch.exp(cum), torch.exp(last - cum)
    w, T = E * dtk, torch.exp(last[..., 0])

    # 1, 2
    dS_own = torch.einsum("bcqhn,bcqhp->bchnp", Ch,
                          dyc * e.permute(0, 1, 3, 2)[..., None])
    g = x.new_zeros((b, h, ds, p)) if dfinal is None else dfinal
    dSc, dT = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dSc[c] = g
        dT[c] = (g * S[:, c]).sum(dim=(-1, -2))
        g = g * T[:, c, :, None, None] + dS_own[:, c]
    dSc, dT = torch.stack(dSc, dim=1), torch.stack(dT, dim=1)  # dT (b, c, h)
    dinit = g if want_initial else None

    # 3
    L = _decay_mask(cum)
    dM = torch.einsum("bcqhp,bckhp->bchqk", dyc, xc)
    v = dM * CB.repeat_interleave(hg, dim=2) * L
    cs = v.sum(dim=-2)
    rs = (v * dtk[..., None, :]).sum(dim=-1)
    dCB = (dM * L * dtk[..., None, :]).reshape(b, nc, G, hg, Q, Q).sum(3)

    # 4
    u = torch.einsum("bckhn,bchnp->bckhp", Bh, dSc)
    dw = (xc * u).sum(-1).permute(0, 1, 3, 2)
    W = CB.repeat_interleave(hg, dim=2) * L * dtk[..., None, :]
    dx = u * w.permute(0, 1, 3, 2)[..., None] + torch.einsum(
        "bchqk,bcqhp->bckhp", W, dyc)

    # 5
    tmp = torch.einsum("bcqhp,bchnp->bcqhn", dyc, S)
    off = (Ch * tmp).sum(-1).permute(0, 1, 3, 2) * e
    dC = (tmp * e.permute(0, 1, 3, 2)[..., None]).reshape(
        b, nc, Q, G, hg, ds).sum(4) + torch.einsum("bcgqk,bckgn->bcqgn",
                                                   dCB, Bc)
    dB = torch.einsum("bckhp,bchnp->bckhn",
                      xc * w.permute(0, 1, 3, 2)[..., None], dSc).reshape(
        b, nc, Q, G, hg, ds).sum(4) + torch.einsum("bcgqk,bcqgn->bckgn",
                                                   dCB, Cc)

    # 6
    dcum = rs - dtk * cs + off - dw * w
    dcum[..., -1] += (dw * w).sum(-1) + dT * T
    da = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = cs + dw * E + A[:, None] * da
    dA = (dtk * da).sum(dim=(0, 1, 3))
    return (dx.reshape(b, s, h, p), ddt.permute(0, 1, 3, 2).reshape(b, s, h),
            dA, dB.reshape(b, s, G, ds), dC.reshape(b, s, G, ds), dinit)


# ------------------------------------------------------------------ kernels
def check_operands(x, dt, A, B, C, Q, init):
    """Raise unless the operands are what ``csrc/ssd.cu`` takes."""
    ops = {"x": x, "dt": dt, "A": A, "B": B, "C": C}
    if init is not None:
        ops["initial_state"] = init
    for name, t in ops.items():
        build.refuse_dtensor("ssd", t)
        if t.dtype != torch.float32:
            raise ValueError(f"ssd: the kernels run in f32, got {name} "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssd: {name} is on {t.device}, x on {x.device}")
    b, s, h, p = x.shape
    G, ds = B.shape[2], B.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, G, ds)
            or C.shape != B.shape or h % G
            or (init is not None and init.shape != (b, h, ds, p))):
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not agree")
    if not 1 <= Q <= MAX_CHUNK or s % Q:
        raise ValueError(f"ssd: the kernels take chunks of 1 to {MAX_CHUNK} "
                         f"positions dividing the sequence, got {Q} of {s}")
    if p > MAX_HEADDIM or p % 4 or ds % 4:
        raise ValueError(f"ssd: the kernels take head widths up to "
                         f"{MAX_HEADDIM} and widths and states of multiples "
                         f"of 4, got p {p}, ds {ds}")


def dense(t):
    """``t`` contiguous and 16-byte aligned (the kernels' float4 loads);
    None stays None."""
    if t is None:
        return None
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _ptr(t):
    return None if t is None else t.data_ptr()


def ssd_kernel_forward(x, dt, A, B, C, Q: int, initial_state=None, *,
                       keep: bool = True):
    """Launch ``ssd_forward`` on PyTorch's current stream (no sync): y, the
    final state and (cum, S, CB, yoff), the first three of the plain
    mirror's meanings with Q padded to the tile (QT) in ``cum`` and ``CB``;
    ``keep=False`` (no backward to follow) skips ``yoff``."""
    check_operands(x, dt, A, B, C, Q, initial_state)
    b, s, h, p, G, ds, nc = _dims(x, B, Q)
    QT = _up(Q, _TILE)
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x.device)
    y, final = empty((b, s, h, p)), empty((b, h, ds, p))
    cum, S = empty((b, nc, h, QT)), empty((b, nc, h, ds, p))
    CB = empty((b, nc, G, QT, QT))
    yoff = empty((b, s, h, p)) if keep else None
    ins = build.pointers("ssd", x, dt, A, B, C, dtype=torch.float32)
    with build.device_guard(x.device):
        err = build.load().ssd_forward(
            *ins, _ptr(initial_state), y.data_ptr(), final.data_ptr(),
            cum.data_ptr(), S.data_ptr(), CB.data_ptr(), _ptr(yoff), b, s, h,
            p, G, ds, Q, build.stream(x.device))
    build.check(err, "ssd_forward")
    return y, final, (cum, S, CB, yoff)


def ssd_kernel_backward(x, dt, A, B, C, cum, S, CB, yoff, dy, dfinal, *,
                        want_initial: bool = False):
    """Launch ``ssd_backward`` on PyTorch's current stream (no sync), from
    ``ssd_kernel_forward``'s buffers: (dx, ddt, dA, dB, dC, the initial
    state's gradient or None).  dA is the kernels' per-chunk parts summed
    here."""
    b, s, h, p = x.shape
    G, ds, nc, QT = B.shape[2], B.shape[3], S.shape[1], cum.shape[-1]
    Q = s // nc
    nt = QT // _TILE
    npass = -(-(ds * p) // 1024)
    empty = functools.partial(torch.empty, dtype=torch.float32,
                              device=x.device)
    dx, ddt = empty((b, s, h, p)), empty((b, s, h))
    dB, dC = empty((b, s, G, ds)), empty((b, s, G, ds))
    dinit = empty((b, h, ds, p)) if want_initial else None
    dS, dCB = empty((b, nc, h, ds, p)), empty((b, nc, G, QT, QT))
    rowpart, colpart = empty((b, nc, h, nt, QT)), empty((b, nc, h, nt, QT))
    off, dw = empty((b, nc, h, QT)), empty((b, nc, h, QT))
    dtpart, dApart = empty((b, nc, h, npass)), empty((b, nc, h))
    ins = build.pointers("ssd", x, dt, A, B, C, dy, dtype=torch.float32)
    if dfinal is not None:
        build.pointers("ssd", dfinal, dtype=torch.float32)
    with build.device_guard(x.device):
        err = build.load().ssd_backward(
            *ins, _ptr(dfinal), cum.data_ptr(), S.data_ptr(), CB.data_ptr(),
            yoff.data_ptr(),
            *(t.data_ptr() for t in (dS, dCB, rowpart, colpart, off, dw,
                                     dtpart, dApart, dx, ddt, dB, dC)),
            _ptr(dinit), b, s, h, p, G, ds, Q, build.stream(x.device))
    build.check(err, "ssd_backward")
    return dx, ddt, dApart.sum(dim=(0, 1)), dB, dC, dinit


# ----------------------------------------------------------------- autograd
class SSDFunction(torch.autograd.Function):
    """The SSD core's kernels on CUDA tensors: ``apply(x, dt, A, B, C,
    initial_state, Q, count)`` with B and C (b, s, G, ds) and every
    operand ``dense``; ``count(n)`` is told each call's launches.  A
    gradient of y or of the final state
    that autograd leaves out is zeros (``set_materialize_grads``'
    default)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state, Q, count):
        y, final, saved = ssd_kernel_forward(
            x, dt, A, B, C, Q, initial_state,
            keep=any(ctx.needs_input_grad[:6]))
        count(FORWARD_LAUNCHES)
        ctx.save_for_backward(x, dt, A, B, C, *saved)
        ctx.count, ctx.want_initial = count, initial_state is not None
        return y, final

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, *saved = ctx.saved_tensors
        grads = ssd_kernel_backward(x, dt, A, B, C, *saved, dense(dy),
                                    dense(dfinal),
                                    want_initial=ctx.want_initial)
        ctx.count(BACKWARD_LAUNCHES)
        return (*grads, None, None)
