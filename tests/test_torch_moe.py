"""The port's MoE family (``repro_torch.models.moe`` and the moe branches of
the transformer stack, the serve engines, the serve CLI and training)
against the reference's ``repro/models/moe.py`` and its users.

The same seeded numpy inputs go to ``repro`` and to ``repro_torch``; models
start from the reference's own ``init_params`` output, carried over with
``params_from_reference``.  Everything runs on the CPU at small sizes.

Tolerances, by what is compared:

* the dispatch's integer outputs (``dest``, ``tok``, the kept set, the dump
  row) and the expert choice, the dispatched buffer and the gates: equal.
* the combine, given equal expert outputs, gates and dispatch: equal bit
  for bit, in f32 and bf16 (the same adds in the same order).
* f32 outputs, logits, K/V cache rows and the aux loss: rtol 1e-5 plus an
  atol of 1e-5 times the largest magnitude, as in ``test_torch_models.py``
  (the libraries sum matmuls in other orders).
* bf16 outputs: an atol of 2**-5 times the largest magnitude and a mean
  absolute error under 2**-9 of it (``test_torch_models.py``).
* gradients (f32): rtol 1e-5, and for each leaf an atol of 1e-5 times its
  largest magnitude, as in ``test_torch_train.py``.
* tokens, slots, ``verify_log``, ``page_stats`` and the CLI's tick metrics:
  equal; fingerprints to the f32 bound.
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

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from conftest import CACHE_LEN, CHUNK, PAGE
from repro import configs as rconfigs
from repro.models import abstract_params as r_abstract_params
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.models import moe as RM
from repro.models import prefill as r_prefill
from repro.models import train_logits as r_train_logits
from repro.serve import scheduler as RS
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro.serve.serve_step import cache_abstract as r_cache_abstract
from repro.train.train_step import make_loss_fn as r_make_loss_fn
from repro_torch import configs
from repro_torch.dist._tree import flatten_named
from repro_torch.models import (abstract_params, decode_step, extend_step,
                                params_from_reference, prefill, train_logits)
from repro_torch.models import moe as TM
from repro_torch.serve import scheduler as TS
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.serve_step import cache_zeros, paged_pool_zeros
from repro_torch.train.train_step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MOE = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]


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


def bits(t) -> np.ndarray:
    """A tensor's or an array's raw bits, for bit-for-bit comparisons."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy().view(np.int32)
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def T_(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(a, dtype=None):
    a = jnp.asarray(np.array(a))
    return a if dtype is None else a.astype(dtype)


def narrow_moonshot(rc_or_tc):
    """moonshot's routing shape (64 experts, top 6, 2 shared) at smoke
    widths."""
    return dataclasses.replace(rc_or_tc.get_config(
        "moonshot-v1-16b-a3b").smoke(), n_experts=64, top_k=6, n_shared=2)


def cfg_pair(name, **kw):
    if name == "moonshot-narrow":
        rc, tc = narrow_moonshot(rconfigs), narrow_moonshot(configs)
    else:
        rc, tc = rconfigs.get_config(name).smoke(), \
            configs.get_config(name).smoke()
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def reference_params(rc, tc, seed=0):
    rp = r_init_params(rc, jax.random.key(seed))
    return rp, params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), "cpu")


def moe_params(rc, tc, seed=0):
    """One layer's MoE subtree, from the reference's ``init_moe``."""
    rp = RM.init_moe(jax.random.key(seed), rc, jnp.float32)
    return rp, {k: T_(v) for k, v in rp.items()}


def r_dispatch(x, idx, gates, E, C, K):
    """The reference's ``_dispatch_row`` over the rows."""
    return jax.vmap(lambda xr, ir, gr: RM._dispatch_row(xr, ir, gr, E, C, K))(
        J(x), J(idx), J(gates))


# ------------------------------------------------------------ the router
@pytest.mark.parametrize("ties", [False, True])
def test_route_takes_lax_top_k_with_its_tie_order(ties):
    """``route`` against the reference's router, softmax and
    ``jax.lax.top_k``: the same experts in the same order, ties (equal
    router columns give equal probabilities) to the lower index."""
    cfg = configs.get_config("qwen2-moe-a2.7b").smoke()
    E, K, d = cfg.n_experts, cfg.top_k, cfg.d_model
    rng = np.random.default_rng(1)
    router = rng.standard_normal((d, E)).astype(np.float32)
    x = rng.standard_normal((3, 10, d)).astype(np.float32)
    if ties:      # experts 1, 2, 5 and 6 tie, and top every (positive) token
        x = np.abs(x)
        router[:, [1, 2, 5, 6]] = 3 * np.abs(router[:, [1]])
    probs, gates, idx = TM.route(T_(router), T_(x), K)
    rp = jax.nn.softmax(jnp.einsum("bsd,de->bse", J(x), J(router)), axis=-1)
    rv, ri = jax.lax.top_k(rp, K)
    assert np.array_equal(idx.numpy(), np.asarray(ri))
    close(probs, rp)
    close(gates, rv / jnp.sum(rv, axis=-1, keepdims=True))
    if ties:
        assert (idx.numpy() == np.array([1, 2])).all()   # lower index first


# ----------------------------------------------------------- the dispatch
def dispatch_case(case):
    """(x, idx, gates, E, C, K) of a named case."""
    E, K, b, s, d = 8, 2, 3, 16, 8
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    logits = rng.standard_normal((b, s, E)).astype(np.float32)
    C = max(1, int(s * K / E * 1.25))
    if case == "overflow":           # every token picks expert 3 first
        logits[..., 3] += 10.0
    if case == "ties":               # experts 4 and 6 tie everywhere
        logits[..., 6] = logits[..., 4] = logits.max(axis=-1) + 1.0
    if case == "pads":               # the last 6 tokens are one pad token
        x[:, 10:] = x[:, 10:11]
        logits[:, 10:] = logits[:, 10:11]
    probs = torch.softmax(T_(logits), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :K] / vals[..., :K].sum(-1, keepdim=True)
    return x, idx[..., :K].numpy(), gates.numpy(), E, C, K


@pytest.mark.parametrize("case", ["random", "overflow", "ties", "pads"])
def test_dispatch_equals_reference_dispatch_row(case):
    """``dest``, ``tok``, the kept set, the dump row, the buffer and the
    gates against the reference's ``_dispatch_row``, exactly: an expert
    every token picks overflows its capacity and drops past it, tied
    experts both take the tokens, and pad tokens route and hold slots."""
    x, idx, gates, E, C, K = dispatch_case(case)
    want = r_dispatch(x, idx, gates, E, C, K)
    got = TM.dispatch(T_(x), T_(idx), T_(gates), E, C)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    dest = got[1].numpy()
    dropped = dest == E * C
    if case == "overflow":
        assert dropped.sum() == 3 * (16 - C)      # expert 3 full in each row
        tok = got[2].numpy()
        kept3 = (dest // C == 3) & ~dropped
        assert (tok[kept3].reshape(3, C) == np.arange(C)).all()  # first come
    elif case == "pads":
        tok = got[2].numpy()
        assert ((tok >= 10) & ~dropped).any()      # pads hold slots
    assert (got[3].numpy()[dropped] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["random", "overflow"])
def test_combine_is_bitwise_the_reference_scatter_add(case, dtype):
    """Given the same expert outputs, dispatch and gates, ``combine`` equals
    the reference's ``gather_row`` (``moe.py:96-101``, its expression
    below) bit for bit, drops included."""
    jdt, tdt = DTYPES[dtype]
    x, idx, gates, E, C, K = dispatch_case(case)
    b, s, d = x.shape
    _, dest, tok, w = r_dispatch(x, idx, gates, E, C, K)
    out = np.random.default_rng(3).standard_normal(
        (b, E * C, d)).astype(np.float32)
    out_j, w_j = J(out, jdt), w.astype(jdt)

    def gather_row(ob_row, dest_row, tok_row, w_row):
        padded = jnp.concatenate(
            [ob_row, jnp.zeros((1, d), jdt)], axis=0)[dest_row]
        return jnp.zeros((s, d), jdt).at[tok_row].add(
            padded * w_row[:, None])

    want = jax.vmap(gather_row)(out_j, dest, tok, w_j)
    got = TM.combine(T_(out, tdt), T_(dest), T_(tok), T_(w).to(tdt), s)
    assert got.dtype == tdt
    assert np.array_equal(bits(got), bits(want))


# ---------------------------------------------------------- moe_forward
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE + ["moonshot-narrow"])
def test_moe_forward_and_aux_match_reference(name, dtype):
    """``moe_forward`` on (3, 24, d) against the reference's, in f32 and in
    bf16 (bf16 activations over f32 weights cast per use); seq 24 at
    factor 1.25 drops tokens."""
    jdt, tdt = DTYPES[dtype]
    rc, tc = cfg_pair(name)
    rp, tp = moe_params(rc, tc)
    x = np.random.default_rng(4).standard_normal(
        (3, 24, rc.d_model)).astype(np.float32)
    want, waux = jax.jit(lambda p, x: RM.moe_forward(p, rc, x))(rp, J(x, jdt))
    got, aux = TM.moe_forward(tp, tc, T_(x, tdt))
    assert got.dtype == tdt and aux.dtype == torch.float32
    close(got, want.astype(jnp.float32), dtype)
    close(aux, waux)


def test_moe_gradients_match_jax_grad():
    """d/d(params, x) of sum(y * cotangent) + aux against ``jax.grad``, in
    f32, through the gather, the gates and the router's softmax."""
    rc, tc = cfg_pair("qwen2-moe-a2.7b")
    rp, tp = moe_params(rc, tc, seed=1)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, rc.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, 24, rc.d_model)).astype(np.float32)

    def r_loss(p, x):
        y, aux = RM.moe_forward(p, rc, x)
        return jnp.sum(y * J(cot)) + aux

    want_p, want_x = jax.jit(jax.grad(r_loss, argnums=(0, 1)))(rp, J(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = T_(x).requires_grad_()
    y, aux = TM.moe_forward(leaves, tc, xt)
    (torch.sum(y * T_(cot)) + aux).backward()
    for k, g in want_p.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5 * np.abs(g).max(),
                                   err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x),
                               rtol=1e-5,
                               atol=1e-5 * np.abs(want_x).max())


# ------------------------------------------------------------ the model
@pytest.mark.parametrize("name", MOE)
def test_abstract_params_match_reference(name):
    """The full configs' trees: the reference's leaf names in its flatten
    order, shapes and dtypes, on "meta"; qwen2-moe-a2.7b counts
    14,004,422,656 parameters."""
    got = flatten_named(abstract_params(configs.get_config(name)))
    want = r_abstract_params(rconfigs.get_config(name))
    want = [(jax.tree_util.keystr(p, simple=True, separator="/"), leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(want)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, t), (_, w) in zip(got, want):
        assert tuple(t.shape) == tuple(w.shape), n
        assert str(t.dtype).split(".")[-1] == str(w.dtype), n
    if name == "qwen2-moe-a2.7b":
        assert sum(t.numel() for _, t in got) == 14_004_422_656


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE + ["moonshot-narrow"])
def test_train_logits_match_reference(name, dtype):
    rc, tc = cfg_pair(name, dtype=dtype)
    rp, tp = reference_params(rc, tc)
    toks = np.random.default_rng(6).integers(0, rc.vocab, (2, 40),
                                             dtype=np.int32)
    want, waux = jax.jit(lambda p, t: r_train_logits(rc, p, {"tokens": t}))(
        rp, J(toks))
    got, aux = train_logits(tc, tp, {"tokens": T_(toks)})
    assert got.dtype == DTYPES[dtype][1] and float(aux) > 0
    close(got, want.astype(jnp.float32), dtype)
    close(aux, waux)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "moonshot-narrow"])
def test_loss_and_gradients_match_value_and_grad(name, remat):
    """The training loss (CE + 0.01 * aux) and every gradient leaf against
    ``jax.value_and_grad``; with ``remat`` the aux rides out of
    ``torch.utils.checkpoint``."""
    rc, tc = cfg_pair(name, remat=remat)
    rp, tp = reference_params(rc, tc)
    toks = np.random.default_rng(7).integers(0, rc.vocab, (2, 41),
                                             dtype=np.int32)
    (rl, (rce, raux)), rg = jax.jit(jax.value_and_grad(
        r_make_loss_fn(rc), has_aux=True))(rp, {"tokens": J(toks)})
    loss, ce, aux, grads = value_and_grad(make_loss_fn(tc), tp,
                                          {"tokens": T_(toks)})
    for g, w in ((loss, rl), (ce, rce), (aux, raux)):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert float(aux) > 0
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(rg)}
    got = {n: t.numpy() for n, t in flatten_named(grads)}
    assert list(got) == list(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


# -------------------------------------------------------------- serving
def same_cache(got: dict, want: dict):
    assert sorted(got) == sorted(want), (list(got), list(want))
    for name, w in want.items():
        if name == "len":
            assert got[name] == int(np.asarray(w)), name
        else:
            assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
            close(got[name], np.asarray(w))


@pytest.mark.parametrize("name", MOE)
def test_prefill_decode_extend_match_reference(name):
    """prefill of two 30-token prompts into a 64-position cache (C of 30
    tokens drops), 4 decode steps, an extend of a 6-token chunk at per-row
    positions reading one logit position, and a decode step at per-row
    positions: logits and every cache leaf after each call; the cache's
    leaves are ``cache_zeros``' (the reference's ``cache_abstract``)."""
    rc, tc = cfg_pair(name)
    rp, tp = reference_params(rc, tc)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, rc.vocab, (2, 30), dtype=np.int32)
    S = 64
    want, wc = jax.jit(lambda p, t: r_prefill(rc, p, {"tokens": t}, S))(
        rp, J(toks))
    got, gc = prefill(tc, tp, {"tokens": T_(toks)}, S)
    close(got, want)
    same_cache(gc, wc)
    zeros = cache_zeros(tc, 2, S, "cpu")
    abstract = r_cache_abstract(rc, jax.eval_shape(
        lambda: r_init_params(rc, jax.random.key(0))), 2, S)
    assert sorted(zeros) == sorted(abstract)
    assert all(tuple(zeros[k].shape) == abstract[k].shape
               for k in zeros if k != "len")
    r_dec = jax.jit(lambda p, c, t, pos: r_decode_step(rc, p, c, t, pos))
    for pos in range(30, 34):
        t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
        want, wc = r_dec(rp, wc, J(t), jnp.int32(pos))
        got, gc = decode_step(tc, tp, gc, T_(t), pos)
        close(got, want)
    same_cache(gc, wc)
    chunk = rng.integers(0, rc.vocab, (2, 6), dtype=np.int32)
    rows = np.array([34, 40], np.int32)
    want, wc = jax.jit(lambda p, c, t, pos: r_extend_step(
        rc, p, c, t, pos, logit_index=3))(rp, wc, J(chunk), J(rows))
    got, gc = extend_step(tc, tp, gc, T_(chunk), rows, logit_index=3)
    close(got, want)
    same_cache(gc, wc)
    t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
    want, wc = r_dec(rp, wc, J(t), J(rows + 6))
    got, gc = decode_step(tc, tp, gc, T_(t), rows + 6)
    close(got, want)
    same_cache(gc, wc)


def test_paged_decode_and_extend_match_reference():
    """The paged stack on qwen2-moe's smoke config from one pool: a chunk
    extend, a bucketed extend with ``valid_len``/``scratch`` (its pads
    route through the experts and take capacity), and two decode steps
    with a parked row; logits and every live page."""
    rc, tc = cfg_pair("qwen2-moe-a2.7b")
    rp, tp = reference_params(rc, tc, seed=4)
    rng = np.random.default_rng(9)
    P = 13
    pool = paged_pool_zeros(tc, P, PAGE, "cpu")
    rpool = {"k": jnp.zeros(pool["k"].shape, jnp.float32),
             "v": jnp.zeros(pool["v"].shape, jnp.float32),
             "len": jnp.int32(0)}
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    dec_pos = [[8, 8, CACHE_LEN - 1], [9, 9, CACHE_LEN - 1]]
    for kind, row, pos, valid, scratch in [("extend", 0, 0, None, None),
                                           ("extend", 1, 3, 5, 11),
                                           ("decode", None, None, None, None),
                                           ("decode", None, None, None, None)]:
        if kind == "extend":
            toks = rng.integers(1, tc.vocab, (1, 8))
            pg = table[row:row + 1]
            kw = {} if valid is None else {"valid_len": valid,
                                           "scratch": scratch}
            want, rpool = jax.jit(lambda p, c, t, pg: r_extend_step(
                rc, p, c, t, jnp.int32(pos), pages=pg, page_size=PAGE,
                **{k: jnp.int32(v) for k, v in kw.items()}))(
                rp, rpool, jnp.asarray(toks, jnp.int32), jnp.asarray(pg))
            got, pool = extend_step(tc, tp, pool, T_(toks), pos,
                                    pages=T_(pg), page_size=PAGE, **kw)
        else:
            toks = rng.integers(1, tc.vocab, (3, 1))
            p = dec_pos.pop(0)
            want, rpool = jax.jit(lambda pr, c, t, ps, pg: r_decode_step(
                rc, pr, c, t, ps, pages=pg, page_size=PAGE))(
                rp, rpool, jnp.asarray(toks, jnp.int32),
                jnp.asarray(p, jnp.int32), jnp.asarray(table))
            got, pool = decode_step(tc, tp, pool, T_(toks), p,
                                    pages=T_(table), page_size=PAGE)
        close(got, want)
        live = [i for i in range(P) if i not in (0, 11)]
        for n in ("k", "v"):
            close(pool[n][:, live], np.asarray(rpool[n])[:, live])


@pytest.fixture(scope="module")
def moe_models():
    rc, tc = cfg_pair("qwen2-moe-a2.7b")
    rp, tp = reference_params(rc, tc)
    return rc, rp, tc, tp


def traffic(mod, vocab):
    """Shared-prefix traffic on the serve geometry: three requests behind a
    16-token prefix, one bare prefix, and one alone."""
    rng = np.random.default_rng(10)
    pre = [int(t) for t in rng.integers(1, vocab, 16)]
    mk = lambda rid, prompt, n: mod.Request(rid=rid, prompt=prompt,
                                            max_new=n)
    return [mk(0, pre + [5, 6, 7], 6), mk(1, pre + [9], 5),
            mk(2, list(pre), 4),
            mk(3, [int(t) for t in rng.integers(1, vocab, 11)], 7),
            mk(4, pre + [2, 2], 3)]


@pytest.mark.parametrize("paged", [False, True])
def test_engines_match_reference(moe_models, paged):
    """Both packages' engines (batched cache, or the paged pool with pages
    of 8) on the same traffic under rns_verify: tokens and slots equal,
    ``verify_log`` and the census equal, ``page_stats`` equal on the pool,
    and each stored fingerprint to the f32 bound."""
    rc, rp, tc, tp = moe_models
    out = {}
    for k, (Eng, mod, cfg, params) in {
            "r": (RBatcher, RS, rc, rp), "t": (ContinuousBatcher, TS, tc, tp),
    }.items():
        eng = Eng(cfg, params, n_slots=3, cache_len=CACHE_LEN,
                  prefill_chunk=CHUNK, rns_verify=True,
                  page_size=PAGE if paged else None)
        for r in traffic(mod, cfg.vocab):
            eng.submit(r)
        eng.run_to_completion()
        sizes = eng.jit_cache_sizes()
        if paged:
            fps = {pid: np.asarray(eng._fp_fn(eng.cache, *(
                (jnp.int32(pid), jnp.int32(eng._page_span[pid])) if k == "r"
                else (pid, eng._page_span[pid]))))
                for pid in sorted(eng.wire.keys())}
            stats = eng.page_stats()
        else:
            fps = {r.rid: np.asarray(eng._fp_fn(eng.cache, r.slot_index,
                                                len(r.prompt)))
                   for r in eng.sched.completed}
            stats = None
        out[k] = ({r.rid: (r.out, r.slot_index) for r in
                   eng.sched.completed}, dict(eng.verify_log), sizes,
                  stats, fps)
    for i in range(4):
        assert out["t"][i] == out["r"][i], i
    assert len(out["t"][1]) == 5 and all(out["t"][1].values())
    assert sorted(out["t"][4]) == sorted(out["r"][4])
    for key, want in out["r"][4].items():
        close(torch.from_numpy(out["t"][4][key]), want)


def kv_rows(eng, r):
    """A request's written K/V span, from either layout."""
    end = len(r.prompt) + len(r.out) - 1
    if eng.paged:
        raise AssertionError("read paged rows before release")
    return tuple(eng.cache[n][:, r.slot_index, :end].clone()
                 for n in ("k", "v"))


def test_a_request_alone_equals_packed_bit_for_bit(moe_models):
    """Rows never mix in the per-row dispatch and the combine has no
    atomics: each request's tokens and K/V rows are the same alone on a
    fresh engine as packed with the others, bit for bit."""
    _, _, tc, tp = moe_models
    eng = ContinuousBatcher(tc, tp, n_slots=3, cache_len=CACHE_LEN,
                            prefill_chunk=CHUNK)
    rows = {}
    orig = eng.step

    def step(now=0.0):
        retired = orig(now)
        for r in retired:
            rows[r.rid] = kv_rows(eng, r)
        return retired

    eng.step = step
    for r in traffic(TS, tc.vocab):
        eng.submit(r)
    eng.run_to_completion()
    packed = {r.rid: r for r in eng.sched.completed}
    for rid in (0, 3):
        solo = ContinuousBatcher(tc, tp, n_slots=3, cache_len=CACHE_LEN,
                                 prefill_chunk=CHUNK)
        r = TS.Request(rid=rid, prompt=list(packed[rid].prompt),
                       max_new=packed[rid].max_new)
        solo.submit(r)
        solo.run_to_completion()
        assert r.out == packed[rid].out
        for a, b in zip(kv_rows(solo, r), rows[rid]):
            assert torch.equal(a, b)


# ----------------------------------------------------------------- CLIs
SIM_ARGS = ["--arch", "qwen2-moe-a2.7b", "--requests", "5", "--slots", "3",
            "--cache-len", "64", "--prefill-chunk", "8", "--max-new", "5",
            "--rns-verify"]


def run_cli(module, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if module.startswith("repro_torch") else []
    return subprocess.run([sys.executable, "-m", module, *extra, *argv],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)


def report_of(stdout: str) -> dict:
    start = 0 if stdout.startswith("{") else stdout.index("\n{") + 1
    return json.JSONDecoder().raw_decode(stdout[start:])[0]


@pytest.mark.parametrize("mode", ["sim", "sim-paged", "offline"])
def test_serve_cli_matches_reference_cli(mode, tmp_path):
    """The serve CLI on qwen2-moe's smoke config in both packages: sim on
    the batched cache (an injected wire fault repaired), sim on the paged
    pool, and offline with pow2 buckets on the pool.  The workload's
    metrics equal: the tick metrics, the census and the RRNS block in sim,
    ``paging`` on the pool; offline the counts, buckets, census and
    fingerprints."""
    argv = list(SIM_ARGS)
    if mode == "sim":
        argv += ["--inject-wire-corrupt"]
    else:
        argv += ["--page-size", "16"]
    if mode == "offline":
        argv += ["--mode", "offline"]
    outs = [run_cli(m, argv, tmp_path) for m in ("repro_torch.launch.serve",
                                                  "repro.launch.serve")]
    for o in outs:
        assert o.returncode == 0, o.stderr
    g, w = (report_of(o.stdout) for o in outs)
    keys = (("arch", "mode", "engine", "n_slots", "cache_len", "requests",
             "tokens_out", "buckets", "jit_traces", "retrace_free", "rns",
             "replicas") if mode == "offline" else
            ("arch", "engine", "n_slots", "cache_len", "requests",
             "tokens_out", "steps", "max_concurrency", "ttft_ticks",
             "latency_ticks", "jit_traces", "rns")
            + (("paging",) if mode == "sim-paged" else ()))
    for key in keys:
        assert g[key] == w[key], key
    assert g["arch"] == "qwen2-moe-a2.7b-smoke" and g["tokens_out"] == 25
    if mode == "sim":
        assert g["rns"]["injected_repair"] == {"repaired": 1,
                                               "unrecoverable": 0}
    if mode == "offline":
        assert g["rns"] == {"slots_verified": 5, "slots_failed": 0}


# ------------------------------------------------------------- training
def test_train_cli_trains_moe_through_the_codec(capsys):
    """The training CLI on qwen2-moe's smoke config, through the RNS
    gradient codec on a one-rank gloo group: finite losses, and the aux
    loss of every step in the summary."""
    from repro_torch.launch import train as launch_train

    params, summary = launch_train.main(
        ["--device", "cpu", "--arch", "qwen2-moe-a2.7b", "--steps", "3",
         "--batch", "2", "--seq", "16", "--rns-allreduce"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == summary
    assert len(summary["auxes"]) == 3 and all(a > 0 for a in summary["auxes"])
    assert all(np.isfinite(summary["losses"]))
    assert all(bool(torch.isfinite(p).all()) for _, p in flatten_named(params))
