"""The SSD core's kernels (``repro_torch/kernels/ssd.py``, ``csrc/ssd.cu``).

On the CPU: the kernels' plain mirrors, stage by stage, against
``torch.autograd`` of the port's plain ``models.ssm.ssd`` (one group and
two; a chunk of 16 and a ragged one, 24 of 48; with and without an initial
state; the final state's gradient given and left out), the saved buffers
the backward reads, the decay-mask regime (decays within a chunk past
88.7, where f32 ``exp`` is inf) against float64, ``ops.ssd_op`` on CPU
tensors (the plain version, bit for bit), and the wrapper's refusals.

On the card (marked ``cuda``; this file imports no JAX, so they run there):
``ssd_op`` against the plain mirrors at a mamba2-370m layer, a zamba2-7b
layer, a prefill whose chunk is not a multiple of 64 and the shape of one
``_ssd_on_mesh`` shard; in the decay regime (Q 256 and a ragged 100)
against float64 mirrors; and ``ssd_op.launches`` per call.

Tolerances are relative Frobenius norms in f32 (``_rel``): 1e-5 where the
mirror or the kernels and autograd sum the same products in another order
(the readings are 1e-7 to 3e-6), and 2e-4 for dA in the decay regime,
where f32 sums of 256 positions' terms of order one land some 3e-5 of its
norm from float64.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ssd as K
from repro_torch.models import ssm

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp_min(1e-300)).item()


def _inputs(b, s, h, p, G, ds, *, seed=0, init=True, decay=False,
            device="cpu", dtype=torch.float32):
    """Seeded operands of ``ssd``: dt about 0.06 (or, with ``decay``, about
    0.7 with A = -2, the decay-mask test's regime), A in (-1.5, -0.5)."""
    g = torch.Generator().manual_seed(seed)
    f = dict(dtype=torch.float64)
    x = torch.randn(b, s, h, p, generator=g, **f)
    if decay:
        dt = torch.nn.functional.softplus(0.3 * torch.randn(b, s, h,
                                                            generator=g, **f))
        A = torch.full((h,), -2.0, **f)
    else:
        dt = 0.01 + 0.1 * torch.rand(b, s, h, generator=g, **f)
        A = -(0.5 + torch.rand(h, generator=g, **f))
    B = 0.3 * torch.randn(b, s, G, ds, generator=g, **f)
    C = 0.3 * torch.randn(b, s, G, ds, generator=g, **f)
    S0 = torch.randn(b, h, ds, p, generator=g, **f) if init else None
    out = [x, dt, A, B, C, S0]
    return [None if t is None else t.to(device=device, dtype=dtype)
            for t in out]


def _model_grads(ins, Q, dy, dfinal):
    """(y, final, the gradients of x, dt, A, B, C[, S0]) by autograd of
    ``models.ssm.ssd``, B and C without the group axis for one group."""
    leaves = [t.clone().requires_grad_() for t in ins if t is not None]
    x, dt, A, B, C = leaves[:5]
    if B.shape[2] == 1:
        B, C = B[:, :, 0], C[:, :, 0]
    y, final = ssm.ssd(x, dt, A, B, C, Q, leaves[5] if len(leaves) > 5
                       else None)
    loss = (y * dy).sum()
    if dfinal is not None:
        loss = loss + (final * dfinal).sum()
    grads = torch.autograd.grad(loss, leaves)
    return y.detach(), final.detach(), grads


def _cotangents(y_shape, f_shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed + 1)
    return (torch.randn(y_shape, generator=g).to(dtype),
            torch.randn(f_shape, generator=g).to(dtype))


SHAPES = {"q16": (2, 32, 4, 16, 16, 16),       # b, s, h, p, ds, Q
          "ragged": (2, 48, 4, 16, 16, 24)}


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_mirror_matches_ssd(groups, shape):
    """``ssd_forward_plain`` gives ``ssm.ssd``'s y and final state, and its
    buffers mean what the backward reads: cum the within-chunk cumsum of
    dt A, S the state entering each chunk (the final state after the
    last), CB = C B^T a group."""
    b, s, h, p, ds, Q = SHAPES[shape]
    ins = _inputs(b, s, h, p, groups, ds, seed=groups)
    x, dt, A, B, C, S0 = ins
    y, final, (cum, S, CB) = K.ssd_forward_plain(x, dt, A, B, C, Q, S0)
    Bm, Cm = (B[:, :, 0], C[:, :, 0]) if groups == 1 else (B, C)
    want_y, want_final = ssm.ssd(x, dt, A, Bm, Cm, Q, S0)
    assert _rel(y, want_y) < 1e-5 and _rel(final, want_final) < 1e-5
    nc = s // Q
    want_cum = torch.cumsum((dt * A).reshape(b, nc, Q, h), dim=2)
    assert _rel(cum, want_cum.permute(0, 1, 3, 2)) < 1e-6
    assert torch.equal(S[:, 0], S0)
    _, state1 = ssm.ssd(x[:, :Q], dt[:, :Q], A, Bm[:, :Q], Cm[:, :Q], Q, S0)
    assert _rel(S[:, 1], state1) < 1e-5
    Bc, Cc = B.reshape(b, nc, Q, groups, ds), C.reshape(b, nc, Q, groups, ds)
    want_cb = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    assert _rel(CB, want_cb) < 1e-6


@pytest.mark.parametrize("dfinal", ["given", "none"])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("groups", [1, 2])
def test_backward_mirror_matches_autograd(groups, shape, init, dfinal):
    """``ssd_backward_plain`` from ``ssd_forward_plain``'s buffers against
    ``torch.autograd`` of ``ssm.ssd``: every gradient within 1e-5."""
    b, s, h, p, ds, Q = SHAPES[shape]
    ins = _inputs(b, s, h, p, groups, ds, seed=3 * groups + init, init=init)
    x, dt, A, B, C, S0 = ins
    y, final, (cum, S, CB) = K.ssd_forward_plain(x, dt, A, B, C, Q, S0)
    dy, dF = _cotangents(y.shape, final.shape, seed=groups)
    dF = dF if dfinal == "given" else None
    got = K.ssd_backward_plain(x, dt, A, B, C, cum, S, CB, dy, dF,
                               want_initial=init)
    _, _, want = _model_grads(ins, Q, dy, dF)
    assert (got[5] is None) == (not init)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, name
        assert _rel(g, w) < 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("groups", [1, 2])
def test_decay_regime_gradients_finite(groups):
    """The decay-mask test's regime: A = -2, dt about 0.7, chunks of 128,
    so the decay above the diagonal reaches some 180, past f32 ``exp``'s
    88.7.  Every exp the mirrors take is of a non-positive difference: all
    gradients finite, and within the f32 tolerance of float64 autograd of
    ``ssm.ssd`` (dA within 2e-4: module docstring)."""
    b, s, h, p, ds, Q = 1, 256, 4, 8, 8, 128
    ins = _inputs(b, s, h, p, groups, ds, seed=11, decay=True)
    x, dt, A, B, C, S0 = ins
    cum = torch.cumsum((dt * A).reshape(b, 2, Q, h), dim=2)
    assert (cum[:, :, 0] - cum[:, :, -1]).max() > 88.7
    y, final, (cum, S, CB) = K.ssd_forward_plain(x, dt, A, B, C, Q, S0)
    dy, dF = _cotangents(y.shape, final.shape, seed=5)
    got = K.ssd_backward_plain(x, dt, A, B, C, cum, S, CB, dy, dF,
                               want_initial=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    ins64 = [t.double() for t in ins]
    want_y, _, want = _model_grads(ins64, Q, dy.double(), dF.double())
    assert _rel(y, want_y) < 1e-5
    for name, g, w in zip(GRADS, got, want):
        assert _rel(g, w) < (2e-4 if name == "dA" else 1e-5), name


@pytest.mark.parametrize("case", ["one_group_3d", "y_only", "state_only"])
def test_ssd_op_function_on_cpu(case):
    """``ops.ssd_op`` on CPU tensors is the plain version,
    ``kernels.ssd.ssd_plain``: y, the final state and every gradient bit for
    bit, no launch counted.  B and C without a group axis ("one_group_3d");
    a loss of y alone or of the final state alone (which C does not reach:
    its gradient is zeros)."""
    b, s, h, p, ds, Q = SHAPES["ragged"]
    ins = _inputs(b, s, h, p, 1, ds, seed=21)
    ins[3], ins[4] = ins[3][:, :, 0], ins[4][:, :, 0]
    dy, dF = _cotangents((b, s, h, p), (b, h, ds, p), seed=8)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        y, final = fn(*leaves[:5], Q, leaves[5])
        if case == "state_only":
            loss = (final * dF).sum()
        elif case == "y_only":
            loss = (y * dy).sum()
        else:
            loss = (y * dy).sum() + (final * dF).sum()
        return (y, final, *torch.autograd.grad(
            loss, leaves, allow_unused=True, materialize_grads=True))

    before = ops.ssd_op.launches
    got = run(ops.ssd_op)
    assert ops.ssd_op.launches == before
    for name, g, w in zip(("y", "final") + GRADS, got, run(K.ssd_plain)):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("bad", ["f64", "long_chunk", "wide_head",
                                 "odd_state", "ragged_chunk"])
def test_kernel_wrapper_refuses(bad):
    """The shapes and types the kernels do not take raise before a launch
    (``ssd.check_operands``, run for every CUDA tensor; here on CPU
    tensors)."""
    b, s, h, p, ds, Q = 1, 512, 2, 16, 16, 256
    if bad == "long_chunk":
        Q = 512
    if bad == "wide_head":
        p = 80
    if bad == "odd_state":
        ds = 18
    if bad == "ragged_chunk":
        Q = 96
    ins = _inputs(b, s, h, p, 1, ds, dtype=(torch.float64 if bad == "f64"
                                           else torch.float32))
    with pytest.raises(ValueError):
        K.check_operands(*ins[:5], Q, ins[5])


# ------------------------------------------------- on the card (skip here)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = {
    # b, s, h, p, G, ds, Q
    "mamba2_370m": (8, 2048, 32, 64, 1, 128, 256),
    "zamba2_7b": (2, 4096, 112, 64, 2, 64, 256),
    "prefill_100": (2, 100, 32, 64, 1, 128, 100),
    "mesh_block_shape": (4, 2048, 16, 64, 1, 128, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_cuda_ssd_op_matches_plain(card, shape):
    """``ssd_op``'s kernels against the plain mirrors on the card, in f32
    (TF32 off): y, the final state and every gradient within 1e-5, from a
    given initial state and final state's gradient.  "mesh_block_shape" is
    the shape of the block one device of a (2, 2) batch x heads mesh runs
    under ``_ssd_on_mesh``'s ``local_map`` at mamba2-370m's layer: half the
    rows and half the heads (the CPU mesh tests run that route)."""
    b, s, h, p, G, ds, Q = CARD_SHAPES[shape]
    ins = _inputs(b, s, h, p, G, ds, seed=31, device=card)
    leaves = [t.clone().requires_grad_() for t in ins]
    y, final = ops.ssd_op(*leaves[:5], Q, leaves[5])
    dy, dF = (t.to(card) for t in _cotangents(y.shape, final.shape, seed=9))
    got = torch.autograd.grad((y * dy).sum() + (final * dF).sum(), leaves)
    torch.cuda.synchronize()
    with torch.no_grad():
        want_y, want_final, (cum, S, CB) = K.ssd_forward_plain(*ins[:5], Q,
                                                               ins[5])
        want = K.ssd_backward_plain(*ins[:5], cum, S, CB, dy, dF,
                                    want_initial=True)
    assert _rel(y, want_y) < 1e-5 and _rel(final, want_final) < 1e-5
    for name, g, w in zip(GRADS, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < 1e-5, (name, _rel(g, w))


DECAY_SHAPES = {
    # b, s, h, p, G, ds, Q: chunks of 256 and of a ragged 100
    "q256": (2, 512, 8, 64, 2, 64, 256),
    "ragged_100": (2, 200, 8, 64, 1, 128, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(DECAY_SHAPES))
def test_cuda_decay_regime_finite(card, shape):
    """The kernels in the decay-mask test's regime (A = -2, dt about 0.7),
    where the decay within a chunk passes f32 ``exp``'s 88.7: the masking
    of the staged tiles and of the padded positions of a ragged chunk
    keeps y, the final state and every gradient finite, and within the f32
    tolerances of ``test_decay_regime_gradients_finite`` of the float64
    mirrors (dA within 2e-4: module docstring)."""
    b, s, h, p, G, ds, Q = DECAY_SHAPES[shape]
    ins = _inputs(b, s, h, p, G, ds, seed=51, decay=True, device=card)
    x, dt, A = ins[:3]
    cum = torch.cumsum((dt * A).reshape(b, s // Q, Q, h), dim=2)
    assert (cum[:, :, 0] - cum[:, :, -1]).max() > 88.7
    leaves = [t.clone().requires_grad_() for t in ins]
    y, final = ops.ssd_op(*leaves[:5], Q, leaves[5])
    dy, dF = (t.to(card) for t in _cotangents(y.shape, final.shape, seed=6))
    got = torch.autograd.grad((y * dy).sum() + (final * dF).sum(), leaves)
    torch.cuda.synchronize()
    ins64 = [t.double() for t in ins]
    with torch.no_grad():
        want_y, want_final, (cum, S, CB) = K.ssd_forward_plain(*ins64[:5], Q,
                                                               ins64[5])
        want = K.ssd_backward_plain(*ins64[:5], cum, S, CB, dy.double(),
                                    dF.double(), want_initial=True)
    for name, g, w in zip(("y", "final") + GRADS, (y, final, *got),
                          (want_y, want_final, *want)):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < (2e-4 if name == "dA" else 1e-5), (name,
                                                                _rel(g, w))


@pytest.mark.cuda
def test_cuda_ssd_op_launches(card):
    """Each call's forward launches 4 kernels and its backward 6, counted
    on ``ssd_op.launches``; a forward without gradients launches 4."""
    ins = _inputs(2, 512, 8, 64, 2, 64, seed=41, device=card)
    ops.reset_launches()
    for _ in range(3):
        leaves = [t.clone().requires_grad_() for t in ins]
        y, final = ops.ssd_op(*leaves[:5], 256, leaves[5])
        (y.sum() + final.sum()).backward()
    with torch.no_grad():
        ops.ssd_op(*ins[:5], 256, None)
    torch.cuda.synchronize()
    counts = ops.reset_launches()
    assert counts["ssd_op"] == 3 * (K.FORWARD_LAUNCHES
                                    + K.BACKWARD_LAUNCHES) + K.FORWARD_LAUNCHES
    assert sum(v for k, v in counts.items() if k != "ssd_op") == 0
