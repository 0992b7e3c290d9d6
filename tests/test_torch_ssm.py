"""The port's ssm and hybrid families (``repro_torch.models.ssm``,
``ssm_models``, their serving caches and the CLIs on them) against the
reference's.

The same seeded numpy inputs go to ``repro`` and to ``repro_torch``; models
start from the reference's own ``init_params`` output, carried over with
``params_from_reference``.  Everything runs on the CPU at the smoke configs
of mamba2-370m (2 layers, d 128, chunk 16) and zamba2-1.2b (2 groups of 6
Mamba2 layers and the shared block), and at zamba2's smoke widths cut to 5
layers in 2 groups of 2 and a 1-layer tail (the full config has a 2-layer
tail, the smoke config none); or at a narrower one where a test says so.

Tolerances, by what is compared:

* f32 outputs, states and cache leaves: rtol 1e-5 plus an atol of 1e-5
  times the largest magnitude (``test_torch_models.py``); the libraries
  sum matmuls, the within-chunk cumsum and the SSD's contractions in other
  orders.
* bf16 compute: an atol of 2**-5 times the largest magnitude and a mean
  absolute error under 2**-9 of it (``test_torch_models.py``), on stacks
  of at most 5 layers: single ulps between the libraries' bf16 roundings
  compound with depth, and the 12-layer hybrid's logits sit at twice
  that mean.
* loss (f32): rtol 1e-5; each gradient leaf: rtol 1e-5 plus an atol of
  1e-5 times its largest magnitude (``test_torch_train.py``).
* the NaN hazard: the two mask orders' forwards equal bit for bit; the
  SSD core's gradients against a float64 central finite difference (step
  1e-6) within rtol 1e-4 plus 1e-4 times the largest magnitude in f32
  (the f32 sums over 256 positions are good to about 2e-5 of it), 1e-6 in
  float64.
* the training CLIs: the printed losses (4 decimals) within 1e-4, the
  final parameters as ``test_torch_train.py`` holds them (each within
  twice the summed learning rates, at most one element in 1,000 beyond
  1e-5), the repaired counts equal.
* tokens, tick metrics, shapes, dtypes and messages: equal.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro import configs as rconfigs
from repro.launch import serve as r_serve
from repro.launch import train as r_train
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import ssm as R
from repro.models import train_logits as r_train_logits
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro.serve.serve_step import cache_abstract as r_cache_abstract
from repro.train.train_step import make_loss_fn as r_make_loss_fn
from repro_torch import configs
from repro_torch.dist._tree import flatten_named
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import (decode_step, extend_step,
                                params_from_reference, prefill, train_logits)
from repro_torch.models import ssm as T
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.serve_step import cache_zeros
from repro_torch.train.train_step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
NAMES = {"ssm": "mamba2-370m", "hybrid": "zamba2-1.2b",
         "hybrid_tail": "zamba2-1.2b"}
CUTS = {"hybrid_tail": {"n_layers": 5, "attn_every": 2}}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def close(got, want, dtype="float32", rtol=1e-5):
    """The tolerances of the module docstring; ``got`` a tensor, ``want``
    anything numpy takes."""
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


def cfgs(name, **kw):
    """(reference cfg, port cfg): ``name``'s smoke config with ``kw``."""
    return (dataclasses.replace(rconfigs.get_config(name).smoke(), **kw),
            dataclasses.replace(configs.get_config(name).smoke(), **kw))


def start(family, **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    rc, tc = cfgs(NAMES[family], **CUTS.get(family, {}), **kw)
    rp = r_init_params(rc, jax.random.key(0))
    return rc, tc, rp, params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), "cpu")


def tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)


def same_tree(got, want, dtype="float32"):
    """Every leaf of the port's tree against the reference's (``len``
    equal)."""
    want = dict(flatten_named(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(flatten_named(got))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        if n == "len":
            assert got[n] == int(w)
            continue
        assert str(got[n].dtype).split(".")[-1] == str(w.dtype), n
        close(got[n], w.astype(np.float32), dtype)


# --------------------------------------------------------------- one block
def block(dtype="float32", **kw):
    """(reference cfg, port cfg, reference block params, port block
    params) of one Mamba2 block."""
    rc, tc = cfgs("mamba2-370m", dtype=dtype, **kw)
    rp = R.init_mamba2(jax.random.key(1), rc, DTYPES[dtype][0])
    tp = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        DTYPES[dtype][1] if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in rp.items()}
    return rc, tc, rp, tp


def both(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_forward_matches_reference(dtype, init):
    """One block over 48 positions (3 chunks of 16): the output, the final
    state S and the conv ring; from zeros or from a given initial state."""
    rc, tc, rp, tp = block(dtype)
    rng = np.random.default_rng(2)
    ru, tu = both(rng.standard_normal((2, 48, rc.d_model))
                  .astype(np.float32), dtype)
    h, p, ds = rc.ssm_heads, rc.ssm_headdim, rc.ssm_state
    S0 = (rng.standard_normal((2, h, ds, p)).astype(np.float32)
          if init else None)
    rkw = {} if S0 is None else {"initial_state": jnp.asarray(S0)}
    tkw = {} if S0 is None else {"initial_state": torch.from_numpy(S0)}
    want, wst = jax.jit(lambda u: R.mamba2_forward(rp, rc, u, **rkw))(ru)
    got, gst = T.mamba2_forward(tp, tc, tu, **tkw)
    assert got.dtype == DTYPES[dtype][1]
    close(got, want.astype(jnp.float32), dtype)
    assert gst["S"].dtype == torch.float32
    assert gst["conv"].dtype == DTYPES[dtype][1]
    close(gst["S"], wst["S"], dtype)
    close(gst["conv"], wst["conv"].astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_plain_is_the_reference_conv(dtype):
    """``ssm._causal_depthwise_conv`` on plain tensors (no mesh): the
    reference's padded shifted products and bias, summed in its order, bit
    for bit before the activation (the port's ``_silu`` of the reference's
    pre-activation sum), and the reference's whole function within the
    module's tolerance (``jax.nn.silu`` and ``x * sigmoid(x)`` round an ulp
    apart)."""
    W = 4
    rng = np.random.default_rng(5)
    (rx, tx), (rw, tw), (rb, tb) = (
        both(rng.standard_normal(sh).astype(np.float32), dtype)
        for sh in ((2, 37, 24), (W, 24), (24,)))
    xp = jnp.pad(rx, ((0, 0), (W - 1, 0), (0, 0)))
    pre = sum(xp[:, i:i + 37, :] * rw[i][None, None, :]
              for i in range(W)) + rb[None, None, :]
    got = T._causal_depthwise_conv(tx, tw, tb)
    assert got.dtype == DTYPES[dtype][1]
    assert torch.equal(got, T._silu(torch.from_numpy(np.asarray(
        pre.astype(jnp.float32))).to(DTYPES[dtype][1])))
    close(got, R._causal_depthwise_conv(rx, rw, rb).astype(jnp.float32),
          dtype)


@pytest.mark.parametrize("s", [1, 2, 3])
def test_conv_ring_of_a_short_prompt(s):
    """A prompt shorter than W - 1 = 3 (and one of exactly 3): the ring is
    zero-left-padded as the reference pads it, and the decode steps after
    it agree."""
    rc, tc, rp, tp = block()
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, s, rc.d_model)).astype(np.float32)
    _, wst = R.mamba2_forward(rp, rc, jnp.asarray(u))
    _, gst = T.mamba2_forward(tp, tc, torch.from_numpy(u))
    assert tuple(gst["conv"].shape) == (2, 3, tc.d_inner + 2 * tc.ssm_state)
    assert not gst["conv"][:, :3 - s].any()
    close(gst["conv"], wst["conv"])
    close(gst["S"], wst["S"])
    for _ in range(3):
        u = rng.standard_normal((2, 1, rc.d_model)).astype(np.float32)
        want, wst = R.mamba2_decode(rp, rc, jnp.asarray(u), wst)
        got, gst = T.mamba2_decode(tp, tc, torch.from_numpy(u), gst)
        close(got, want)
        close(gst["S"], wst["S"])
        close(gst["conv"], wst["conv"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_init_ssm_state_matches_reference(dtype):
    rc, tc = cfgs("mamba2-370m")
    want = R.init_ssm_state(rc, 3, DTYPES[dtype][0])
    got = T.init_ssm_state(tc, 3, DTYPES[dtype][1], "cpu")
    assert sorted(got) == sorted(want) == ["S", "conv"]
    for n, w in want.items():
        assert tuple(got[n].shape) == tuple(w.shape), n
        assert str(got[n].dtype).split(".")[-1] == str(w.dtype), n
        assert not got[n].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_matches_reference(dtype):
    """Five one-token steps from a random state: outputs and states."""
    rc, tc, rp, tp = block(dtype)
    rng = np.random.default_rng(4)
    h, p, ds = rc.ssm_heads, rc.ssm_headdim, rc.ssm_state
    S = rng.standard_normal((2, h, ds, p)).astype(np.float32)
    conv = rng.standard_normal((2, rc.ssm_conv - 1, rc.d_inner + 2 * ds)
                               ).astype(np.float32)
    wst = {"S": jnp.asarray(S), "conv": both(conv, dtype)[0]}
    gst = {"S": torch.from_numpy(S), "conv": both(conv, dtype)[1]}
    dec = jax.jit(lambda u, st: R.mamba2_decode(rp, rc, u, st))
    for _ in range(5):
        ru, tu = both(rng.standard_normal((2, 1, rc.d_model))
                      .astype(np.float32), dtype)
        want, wst = dec(ru, wst)
        got, gst = T.mamba2_decode(tp, tc, tu, gst)
        close(got, want.astype(jnp.float32), dtype)
        close(gst["S"], wst["S"], dtype)
        close(gst["conv"], wst["conv"].astype(jnp.float32), dtype)


def test_chunk_rule_raises_as_the_reference_does():
    """A sequence of 17..31 tokens is no multiple of the chunk of 16: the
    reference asserts, the port raises ValueError with its text; 8 and 32
    tokens pass in both."""
    rc, tc, rp, tp = start("ssm")
    for s in (17, 20, 31):
        t = tokens(rc, 1, s, 5)
        with pytest.raises(AssertionError) as want:
            r_prefill(rc, rp, {"tokens": jnp.asarray(t)}, 48)
        with pytest.raises(ValueError) as got:
            prefill(tc, tp, {"tokens": torch.from_numpy(t)}, 48)
        assert str(got.value) == str(want.value) \
            == "sequence must be a multiple of ssm_chunk"
    for s in (8, 32):
        prefill(tc, tp, {"tokens": torch.from_numpy(tokens(rc, 1, s, 5))}, 48)


# ------------------------------------------------------------------ stacks
@pytest.mark.parametrize("family,dtype", [
    ("ssm", "float32"), ("hybrid", "float32"), ("hybrid_tail", "float32"),
    ("ssm", "bfloat16"), ("hybrid_tail", "bfloat16")])
def test_train_logits_match_reference(family, dtype):
    rc, tc, rp, tp = start(family, dtype=dtype)
    t = tokens(rc, 2, 32, 6)
    want, waux = jax.jit(lambda p, b: r_train_logits(rc, p, b))(
        rp, {"tokens": jnp.asarray(t)})
    got, aux = train_logits(tc, tp, {"tokens": torch.from_numpy(t)})
    assert got.dtype == DTYPES[dtype][1] and float(aux) == float(waux) == 0
    close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", NAMES)
def test_loss_and_gradients_match_value_and_grad(family, remat):
    """Loss and every gradient leaf against ``jax.value_and_grad``, remat
    on and off; the hybrid's ``shared`` leaves hold the sum over the
    groups' uses of the one block."""
    rc, tc, rp, tp = start(family, remat=remat)
    t = tokens(rc, 2, 33, 7)   # 32 inputs, 2 chunks
    (rl, _), rg = jax.jit(jax.value_and_grad(r_make_loss_fn(rc),
                                             has_aux=True))(
        rp, {"tokens": jnp.asarray(t)})
    loss, _, aux, grads = value_and_grad(make_loss_fn(tc), tp,
                                         {"tokens": torch.from_numpy(t)})
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    assert float(aux) == 0.0
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(rg)}
    got = {n: g.numpy() for n, g in flatten_named(grads)}
    assert list(got) == list(want)
    if family != "ssm":
        assert "shared/attn/wq" in got and "groups/mamba/A_log" in got
        assert ("tail/mamba/A_log" in got) == (family == "hybrid_tail")
    for n, w in want.items():
        assert np.isfinite(got[n]).all(), n
        np.testing.assert_allclose(got[n], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


@pytest.mark.parametrize("family", NAMES)
def test_prefill_and_decode_match_reference(family):
    """A prefill of 32 tokens into a 48-position cache (the hybrid's K/V
    padded), then 6 decode steps from position 32: logits and every cache
    leaf after each call."""
    rc, tc, rp, tp = start(family)
    t = tokens(rc, 2, 32, 8)
    want, wc = jax.jit(lambda p, b: r_prefill(rc, p, b, 48))(
        rp, {"tokens": jnp.asarray(t)})
    got, gc = prefill(tc, tp, {"tokens": torch.from_numpy(t)}, 48)
    close(got, want)
    same_tree(gc, wc)
    rng = np.random.default_rng(9)
    r_dec = jax.jit(lambda p, c, t, pos: r_decode_step(rc, p, c, t, pos))
    for pos in range(32, 38):
        nt = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
        want, wc = r_dec(rp, wc, jnp.asarray(nt), jnp.int32(pos))
        got, gc = decode_step(tc, tp, gc, torch.from_numpy(nt), pos)
        close(got, want)
        same_tree(gc, wc)
    assert gc["len"] == 38


@pytest.mark.parametrize("family", NAMES)
@pytest.mark.parametrize("batch,cache_len", [(1, 64), (3, 128)])
def test_cache_zeros_matches_cache_abstract(family, batch, cache_len):
    """The leaves, shapes and dtypes of the reference's ``cache_abstract``
    (an eval_shape of its prefill over cache_len tokens)."""
    rc, tc = cfgs(NAMES[family], **CUTS.get(family, {}))
    want = r_cache_abstract(rc, jax.eval_shape(
        lambda: r_init_params(rc, jax.random.key(0))), batch, cache_len)
    want = dict(flatten_named(want))
    got = dict(flatten_named(cache_zeros(tc, batch, cache_len, "cpu")))
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        if n == "len":
            assert got[n] == 0
            continue
        assert tuple(got[n].shape) == tuple(w.shape), n
        assert str(got[n].dtype).split(".")[-1] == str(w.dtype), n
        assert not got[n].any()


def message(fn, kind=NotImplementedError):
    with pytest.raises(kind) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_extend_paging_and_the_engine_refuse_as_the_reference_does(family):
    rc, tc, rp, tp = start(family)
    toks = np.ones((1, 4), np.int32)
    pages = np.zeros((1, 2), np.int32)
    got = message(lambda: extend_step(tc, tp, {}, torch.from_numpy(toks), 0))
    assert got == message(lambda: r_extend_step(rc, rp, {}, toks, 0))
    got = message(lambda: decode_step(tc, tp, {}, torch.from_numpy(
        toks[:, :1]), 0, pages=pages, page_size=8))
    assert got == message(lambda: r_decode_step(
        rc, rp, {}, toks[:, :1], 0, pages=pages, page_size=8))
    got = message(lambda: ContinuousBatcher(tc, tp, n_slots=1, cache_len=16))
    assert got == message(lambda: RBatcher(rc, rp, n_slots=1, cache_len=16))
    assert repr(rc.family) in got


# --------------------------------------------------------------- NaN hazard
def _reference_order_mask(cum):
    """The reference's decay mask, ``where(tri, exp(rel), 0)``."""
    Q = cum.shape[-1]
    rel = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    return torch.where(tri, torch.exp(rel), torch.zeros((), dtype=rel.dtype))


def test_decay_mask_keeps_gradients_finite(monkeypatch):
    """A narrow block (d 16, 4 heads, state 8) at the published chunk of
    128 over 256 positions, with A = -2 and dt near 0.69: above the
    diagonal the within-chunk decay reaches 175, past 88.7 where f32
    ``exp`` is inf.

    * the reference's ``jax.grad`` holds NaNs (``0 * inf`` under its
      ``where``), and so does the port with the reference's mask order;
    * the port's forward is the reference-order forward bit for bit, and
      the reference's within the f32 tolerance;
    * the port's gradients are finite, and its SSD core's gradients with
      respect to ``dt_bias`` and ``A_log`` equal a float64 central finite
      difference of the same core: in f32 within rtol 1e-4, in float64
      (where ``exp`` overflows past 709, which these decays also reach)
      within rtol 1e-6."""
    kw = dict(d_model=16, ssm_state=8, ssm_headdim=8, ssm_chunk=128)
    rc, tc = cfgs("mamba2-370m", **kw)
    rp = R.init_mamba2(jax.random.key(0), rc, jnp.float32)
    rp = dict(rp, A_log=jnp.full_like(rp["A_log"], np.log(2.0)),
              dt_bias=jnp.zeros_like(rp["dt_bias"]))
    u = np.random.default_rng(10).standard_normal((1, 256, 16)).astype(
        np.float32)

    def r_loss(p):
        return jnp.sum(R.mamba2_forward(p, rc, jnp.asarray(u))[0])

    rg = jax.grad(r_loss)(rp)
    assert any(bool(jnp.isnan(rg[k]).any())
               for k in ("A_log", "dt_bias", "in_proj"))

    def t_grads():
        leaves = {k: torch.from_numpy(np.array(v)).requires_grad_()
                  for k, v in rp.items()}
        out, st = T.mamba2_forward(leaves, tc, torch.from_numpy(u))
        out.sum().backward()
        return out.detach(), st["S"], {k: v.grad for k, v in leaves.items()}

    out, S, grads = t_grads()
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    want, wst = R.mamba2_forward(rp, rc, jnp.asarray(u))
    close(out, want)
    close(S, wst["S"])
    with monkeypatch.context() as m:
        m.setattr(T, "_decay_mask", _reference_order_mask)
        out_r, S_r, grads_r = t_grads()
    assert torch.equal(out_r, out) and torch.equal(S_r, S)
    assert any(bool(torch.isnan(grads_r[k]).any())
               for k in ("A_log", "dt_bias", "in_proj"))

    # the SSD core's autograd gradients against float64 finite differences
    rng = np.random.default_rng(11)
    b, s, h, p, ds = 1, 256, tc.ssm_heads, tc.ssm_headdim, tc.ssm_state
    x = rng.standard_normal((b, s, h, p))
    dtraw = 0.3 * rng.standard_normal((b, s, h))
    Bm, Cm = rng.standard_normal((2, b, s, ds))
    wy = rng.standard_normal((b, s, h, p))
    wS = rng.standard_normal((b, h, ds, p))

    def core(dt_bias, A_log):
        f = dict(dtype=dt_bias.dtype)
        dt = T._softplus(torch.tensor(dtraw, **f) + dt_bias)
        y, S = T.ssd(torch.tensor(x, **f), dt, -torch.exp(A_log),
                     torch.tensor(Bm, **f), torch.tensor(Cm, **f), 128)
        return (y * torch.tensor(wy, **f)).sum() + (
            S * torch.tensor(wS, **f)).sum()

    def f64(point):
        return {n: torch.tensor(a, dtype=torch.float64)
                for n, a in point.items()}

    at = {"dt_bias": np.zeros(h), "A_log": np.full(h, np.log(2.0))}
    auto = {}
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-6)):
        leaves = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
                  for k, v in at.items()}
        core(**leaves).backward()
        auto[dtype] = ({k: leaves[k].grad.numpy() for k in at}, rtol)
    eps = 1e-6
    for k, v in at.items():
        fd = np.empty(h)
        for i in range(h):
            hi = {n: a.copy() for n, a in at.items()}
            lo = {n: a.copy() for n, a in at.items()}
            hi[k][i] += eps
            lo[k][i] -= eps
            fd[i] = float(core(**f64(hi)) - core(**f64(lo))) / (2 * eps)
        for dtype, (g, rtol) in auto.items():
            assert np.isfinite(g[k]).all(), (k, dtype)
            np.testing.assert_allclose(g[k], fd, rtol=rtol,
                                       atol=rtol * np.abs(fd).max(),
                                       err_msg=f"{k} {dtype}")


# ---------------------------------------------------------------- the CLIs
def carried_over(monkeypatch, name):
    """The port's training CLI starting from the reference CLI's
    parameters (its ``init_params(cfg, jax.random.key(0))``)."""
    rc = rconfigs.get_config(name).smoke()
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_init_params(rc, jax.random.key(0)))
    monkeypatch.setattr(t_train, "init_params",
                        lambda cfg, seed, device: params_from_reference(
                            cfg, tree, device))


README_TRAIN = {
    "rns_allreduce": ["--arch", "mamba2-370m", "--steps", "8", "--batch",
                      "2", "--seq", "32", "--rns-allreduce"],
    "rns_correct": ["--arch", "mamba2-370m", "--steps", "4", "--batch", "2",
                    "--seq", "16", "--rns-correct",
                    "--inject-corrupt-step", "2"],
}


@pytest.mark.parametrize("which", README_TRAIN)
def test_readme_training_commands_match_the_reference_cli(which,
                                                          monkeypatch,
                                                          capsys):
    """The README's two mamba2 commands through both training CLIs from
    the same parameters: the losses, the repair of the fault injected at
    step 2 (one value, nothing unrepairable), the final parameters."""
    from repro_torch.train.optimizer import AdamWConfig, _schedule

    argv = README_TRAIN[which]
    rparams = r_train.main(list(argv))
    printed = capsys.readouterr().out
    want = [float(x) for x in re.findall(r"step +\d+ loss=([-\d.]+)",
                                         printed)]
    repaired = re.findall(r"repaired (\d+) corrupted wire value\(s\) in "
                          r"place at step (\d+)", printed)
    carried_over(monkeypatch, "mamba2-370m")
    params, summary = t_train.main(["--device", "cpu", *argv])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    steps = int(argv[argv.index("--steps") + 1])
    assert len(want) == len(summary["losses"]) == steps
    np.testing.assert_allclose(summary["losses"], want, rtol=0, atol=1e-4)
    if which == "rns_correct":
        assert repaired == [("1", "2")]
        assert summary["repaired"] == [int(i == 2) for i in range(steps)]
        assert summary["unrepairable"] == [0] * steps
    opt = AdamWConfig(warmup=5, decay_steps=max(steps, 10))
    lr = sum(float(_schedule(opt, torch.tensor(s)))
             for s in range(1, steps + 1))
    got = dict(flatten_named(params))
    for n, w in flatten_named(jax.tree_util.tree_map(np.asarray, rparams)):
        d = np.abs(got[n].numpy() - w)
        assert d.max() <= 2 * lr, (n, d.max())
        assert (d > 1e-5).sum() <= d.size // 1000, n


@pytest.mark.parametrize("family", NAMES)
def test_single_shot_serving_matches_reference(family):
    """``simulate_single_shot`` on the same requests (prompts of at most
    one chunk), parameters and numpy generator state: the same tokens,
    tick stamps and counters, and the generators left alike."""
    rc, tc, rp, tp = start(family)
    out = {}
    for k, (mod, cfg, params, extra) in {
            "r": (r_serve, rc, rp, ()), "t": (t_serve, tc, tp, ("cpu",)),
    }.items():
        rng = np.random.default_rng(5)
        reqs = mod.synth_requests(3, rng, cfg.vocab, prompt_mean=8,
                                  max_new=5, arrival_rate=0.5)
        assert max(len(r.prompt) for r in reqs) <= cfg.ssm_chunk
        reqs[1].eos = 7
        done, counters = mod.simulate_single_shot(cfg, params, reqs, rng,
                                                  *extra)
        out[k] = ([(r.rid, r.out, r.t_admit, r.t_first, r.t_done)
                   for r in done], counters, rng.standard_normal(3))
    assert out["t"][0] == out["r"][0]
    assert out["t"][1] == out["r"][1]
    assert np.array_equal(out["t"][2], out["r"][2])


def run_cli(module, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if module.startswith("repro_torch") else []
    return subprocess.run([sys.executable, "-m", module, *extra, *argv],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_single_shot_cli_matches_reference_cli(family, tmp_path):
    """The serve CLI on the family's smoke config in both packages: the
    same two ``#`` lines (the engine's refusal, the fallback), then the
    report: single-shot engine, one slot, the tick metrics equal."""
    argv = ["--arch", NAMES[family], "--requests", "3", "--max-new", "4",
            "--prompt-mean", "8"]
    outs = [run_cli(m, argv, tmp_path) for m in ("repro_torch.launch.serve",
                                                  "repro.launch.serve")]
    for o in outs:
        assert o.returncode == 0, o.stderr
    heads = [o.stdout.split("\n{")[0].splitlines() for o in outs]
    assert heads[0] == heads[1] and len(heads[0]) == 2
    assert heads[0][1] == "# falling back to single-shot sequential serving"
    g, w = (json.loads(o.stdout[o.stdout.index("\n{") + 1:]) for o in outs)
    for key in ("arch", "engine", "n_slots", "cache_len", "requests",
                "tokens_out", "steps", "max_concurrency", "ttft_ticks",
                "latency_ticks"):
        assert g[key] == w[key], key
    assert g["engine"] == "single-shot" and g["requests"] == 3
    assert g["tokens_out"] == 12 and g["device"] == "cpu"


@pytest.mark.parametrize("flags", [["--rns-verify"],
                                   ["--crypto-slots", "2"]])
def test_single_shot_refuses_the_engine_only_paths(flags):
    """``--rns-verify`` and the crypto lane need the slot engine: the
    engine's refusal propagates, as in the reference CLI."""
    with pytest.raises(NotImplementedError, match="'ssm'"):
        t_serve.main(["--device", "cpu", "--arch", "mamba2-370m",
                      "--requests", "1", "--prompt-mean", "8", *flags])
