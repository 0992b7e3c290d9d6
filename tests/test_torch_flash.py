"""The port's chunked attention (``repro_torch.models.attention.
flash_attention``, its three routes and its hand-written backward) and the
remat policy (``layers.remat``) against the reference's.

The same seeded numpy inputs go to the reference's ``flash_attention``
(``repro/models/attention.py``) and to the port's: b 2, s 256, h 4, g 2 (f32)
and 1 (bf16), hd 16, chunks of 64; windows of 64 (a chunk edge) and 100
(inside a chunk).

Tolerances, those of ``test_torch_models.py``:

* f32: rtol 1e-5 plus an atol of 1e-5 times the largest magnitude (2e-5
  for gradients).  The libraries sum matmuls in other orders.
* bf16: an atol of 2**-5 times the largest magnitude and a mean absolute
  error under 2**-9 of it (each library rounds its bf16 casts in other
  places).
* ``lse``: f32 as above.  The KV chunks visited, the errors raised and the
  remat policy's gradients: equal.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.models import attention as RA
from repro_torch.configs import get_config
from repro_torch.dist import _tree
from repro_torch.models import init_params, train_logits
from repro_torch.models import attention as TA

ROOT = Path(__file__).resolve().parents[1]
B, S, H, HD, CHUNK = 2, 256, 4, 16, 64
WINDOWS = [None, 64, 100]
DTYPES = {"float32": (jnp.float32, torch.float32, 2),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1)}


def close(got, want, dtype="float32", rtol=1e-5):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)
    else:
        err = np.abs(got - want)
        assert err.max() <= 2.0 ** -5 * scale, (err.max(), scale)
        assert err.mean() <= 2.0 ** -9 * scale, (err.mean(), scale)


def inputs(g, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, s, H, HD), (B, s, g, HD), (B, s, g, HD),
                          (B, s, H, HD))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", TA.IMPLS)
def test_routes_match_reference(impl, causal, window, dtype):
    """Outputs, and for vjp and unrolled dq, dk, dv, against the
    reference's route of the same name (its gradients by ``jax.vjp``)."""
    jd, td, g = DTYPES[dtype]
    q, k, v, do = inputs(g)
    kw = dict(causal=causal, window=window, q_chunk=CHUNK, kv_chunk=CHUNK,
              impl=impl)
    leaves = [torch.from_numpy(a).to(td).requires_grad_(impl != "scan")
              for a in (q, k, v)]
    got = TA.flash_attention(*leaves, **kw)
    assert got.dtype == td
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    if impl == "scan":
        close(got, RA.flash_attention(jq, jk, jv, **kw).astype(jnp.float32),
              dtype)
        return
    want, pullback = jax.vjp(lambda a, b, c: RA.flash_attention(a, b, c, **kw),
                             jq, jk, jv)
    close(got, want.astype(jnp.float32), dtype)
    got.backward(torch.from_numpy(do).to(td))
    for t, w in zip(leaves, pullback(jnp.asarray(do, jd))):
        assert t.grad.dtype == td
        close(t.grad, w.astype(jnp.float32), dtype, rtol=2e-5)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("causal", [True, False])
def test_forward_chunks_lse_match_reference(causal, window):
    q, k, v, _ = inputs(2)
    kw = dict(causal=causal, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    out, lse = TA._flash_fwd_chunks(*(torch.from_numpy(a) for a in (q, k, v)),
                                    **kw)
    r_out, r_lse = RA._flash_fwd_chunks(*(jnp.asarray(a) for a in (q, k, v)),
                                        **kw)
    assert tuple(lse.shape) == (B, 2, H // 2, S) == r_lse.shape
    close(out, r_out)
    close(lse, r_lse)


def reference_bounds(q, k, v, do, kw):
    """The (lo, hi) of every KV loop the reference runs: its forward (the
    vjp and scan routes share it) and its hand-written backward, under
    ``jax.disable_jit`` so that the loop bounds are host values."""
    seen, orig = [], jax.lax.fori_loop

    def fori_loop(lo, hi, body, init):
        seen.append((int(lo), int(hi)))
        return orig(lo, hi, body, init)

    args = [jnp.asarray(a) for a in (q, k, v)]
    with jax.disable_jit():
        jax.lax.fori_loop = fori_loop
        try:
            _, pullback = jax.vjp(
                lambda a, b, c: RA.flash_attention(a, b, c, **kw), *args)
            fwd = list(seen)
            seen.clear()
            pullback(jnp.asarray(do))
        finally:
            jax.lax.fori_loop = orig
    return fwd, list(seen)


class OpCount(TorchDispatchMode):
    """Counts the calls of each op, and the most elements of any tensor an
    op makes."""

    def __init__(self):
        super().__init__()
        self.calls, self.largest = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.calls[name] = self.calls.get(name, 0) + 1
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("window", WINDOWS)
def test_visits_the_reference_kv_chunks(window, monkeypatch):
    """The vjp route's forward and backward loop over the KV chunks the
    reference's do (``kv_bounds``), and run one score product and one PV
    product a chunk in the forward; the unrolled route visits every chunk
    up to the diagonal."""
    q, k, v, do = inputs(2)
    kw = dict(causal=True, window=window, q_chunk=CHUNK, kv_chunk=CHUNK)
    r_fwd, r_bwd = reference_bounds(q, k, v, do, dict(kw, impl="vjp"))
    seen = []
    orig = TA.kv_bounds

    def kv_bounds(qi, nk, **kwargs):
        seen.append(orig(qi, nk, **kwargs))
        return seen[-1]

    monkeypatch.setattr(TA, "kv_bounds", kv_bounds)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with OpCount() as ops:
        out = TA.flash_attention(*leaves, impl="vjp", **kw)
    assert seen == r_fwd
    assert ops.calls.get("bmm", 0) == 2 * sum(hi - lo for lo, hi in r_fwd)
    seen.clear()
    out.backward(torch.from_numpy(do))
    assert seen == r_bwd == r_fwd
    if window is not None:      # the window skips chunks
        assert sum(hi - lo for lo, hi in r_fwd) < S // CHUNK * (
            S // CHUNK + 1) // 2
    seen.clear()
    with OpCount() as ops:
        TA.flash_attention(*leaves, impl="unrolled", **kw)
    assert seen == []
    n = S // CHUNK
    assert ops.calls.get("bmm", 0) == 2 * n * (n + 1) // 2


def test_kv_bounds_non_causal_visits_all():
    assert [TA.kv_bounds(qi, 4, causal=False, window=100, q_chunk=64,
                         kv_chunk=64) for qi in range(4)] == [(0, 4)] * 4


def test_scan_refuses_a_backward_pass():
    q, k, v, _ = inputs(2)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = TA.flash_attention(*leaves, q_chunk=CHUNK, kv_chunk=CHUNK,
                             impl="scan")
    with pytest.raises(RuntimeError, match="reverse-mode unsupported"):
        out.sum().backward()


@pytest.mark.parametrize("case", [
    dict(s=600, skv=600, causal=True, match="pad sequences to chunks"),
    dict(s=512, skv=768, causal=False, kv_chunk=512,
         match="pad sequences to chunks"),
    dict(s=256, skv=256, causal=True, kv_chunk=32,
         match="causal path assumes alignment"),
    dict(s=128, skv=256, causal=True, match="causal path assumes alignment"),
])
def test_refuses_the_lengths_the_reference_refuses(case):
    """A ValueError where the reference's asserts fail, with its text."""
    case = dict(case)
    match, s, skv = case.pop("match"), case.pop("s"), case.pop("skv")
    kw = dict(dict(q_chunk=64, kv_chunk=64), **case)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((1, s, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, skv, 1, 8)).astype(np.float32)
    with pytest.raises(AssertionError, match=match):
        RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                           **kw)
    for impl in TA.IMPLS:
        with pytest.raises(ValueError, match=match):
            TA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(k), impl=impl, **kw)


def test_live_memory_is_a_chunk_not_a_row():
    """At s = 2,048 in chunks of 128 no op of the vjp route, forward or
    backward, nor of the scan route, makes a tensor with more elements
    than the larger of one chunk's score block (b, h, 128, 128) and the
    (b, s, h, hd) inputs; the whole-row ``attention`` makes one more than
    100 times that."""
    s, c = 2048, 128
    q, k, v, do = inputs(2, s=s)
    limit = max(B * H * c * c, B * s * H * HD)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with OpCount() as ops:
        out = TA.flash_attention(*leaves, window=300, q_chunk=c, kv_chunk=c,
                                 impl="vjp")
        out.backward(torch.from_numpy(do))
        with torch.no_grad():
            TA.flash_attention(*leaves, q_chunk=c, kv_chunk=c, impl="scan")
    assert ops.largest <= limit, (ops.largest, limit)
    with OpCount() as ops, torch.no_grad():
        TA.attention(*leaves)
    assert ops.largest > 100 * limit


# ----------------------------------------------------------- remat policy
def smoke_grads(policy, counter):
    """Gradients of a 6-layer smoke gemma3-1b's logits (5 local layers and
    a global one), with remat by ``policy`` (None: remat off), its
    backward pass run under ``counter``."""
    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=6,
                              remat=policy is not None,
                              remat_policy=policy or "nothing")
    params = init_params(cfg, 0, "cpu")
    leaves = _tree.flatten(params)[0]
    for t in leaves:
        t.requires_grad_()
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96)).astype(np.int32))
    logits, _ = train_logits(cfg, params, {"tokens": tok})
    cot = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tuple(logits.shape)).astype(np.float32))
    with counter:
        logits.backward(cot)
    return [t.grad for t in leaves]


def test_remat_dots_saves_the_mms_and_keeps_the_gradients():
    """``remat_policy="dots"`` gives the gradients of "nothing" and of no
    remat, bit for bit, and its backward pass runs no more mm than without
    remat: the outputs of the projections and the MLP were saved, where
    "nothing" recomputes them (all but the last of a layer, whose output
    no backward formula reads, so the recompute stops before it)."""
    counts, grads = {}, {}
    for policy in (None, "nothing", "dots"):
        ops = OpCount()
        grads[policy] = smoke_grads(policy, ops)
        counts[policy] = ops.calls.get("mm", 0)
    for policy in ("nothing", "dots"):
        assert len(grads[policy]) == len(grads[None]) > 2
        for a, b in zip(grads[policy], grads[None]):
            assert torch.equal(a, b)
    assert counts["dots"] == counts[None]
    assert counts["nothing"] == counts[None] + 5 * 6


def test_remat_policy_unknown_raises():
    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), remat=True,
                              remat_policy="everything")
    params = init_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        train_logits(cfg, params, {"tokens": torch.zeros((1, 8),
                                                         dtype=torch.int32)})


# ---------------------------------------------------------------- dry run
def test_dryrun_prefill_32k_fits_a_card(tmp_path):
    """gemma3-1b's prefill_32k cell on the (16, 16) production mesh, in a
    process of its own (the fake group must be its only one): under the
    card's 80 GB a device, where whole-row attention put it at
    123,130,933,508 bytes."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "prefill_32k", "--mesh", "single", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    rec = json.loads(
        (tmp_path / "gemma3-1b__prefill_32k__single.json").read_text())
    mem = rec["memory"]
    assert mem["fits_hbm"] and mem["per_device_bytes"] < 80e9, mem
    assert rec["devices"] == 256
