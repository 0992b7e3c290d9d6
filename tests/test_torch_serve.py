"""The port's serve lane (``repro_torch.models`` prefill/decode/extend,
``repro_torch.serve`` scheduler, steps and ``ContinuousBatcher``, and
``repro_torch.launch.serve``) against the reference's.

The same seeded numpy inputs go to ``repro`` and to ``repro_torch``; the
models start from the reference's own ``init_params`` output, carried over
with ``params_from_reference``.  Everything runs at ``.smoke()`` sizes on
the CPU, where the engine's fingerprint encode takes the codec kernel's
plain version.

Tolerances, by what is compared:

* f32 logits, attention outputs and K/V cache rows: rtol 1e-5 plus an atol
  of 1e-5 times the largest magnitude, as in ``test_torch_models.py``.  The
  libraries sum matmuls and reductions in other orders.
* bf16 attention outputs: an atol of 2**-5 times the largest magnitude and
  a mean absolute error under 2**-9 of it (``test_torch_models.py``).
* int8 cache rows: within one quantization step, and at most one element
  in 1,000 off.  A K/V value that the libraries compute an ulp apart can
  sit on either side of a rounding boundary of ``round(k / scale)``.  The
  f32 scales to the f32 bound.
* the engines' fingerprint vectors (per-layer f32 sums of a row's prompt
  K/V): rtol 1e-5 plus an atol of 1e-5 times the largest magnitude.
* tokens, slot states, scheduler rows, the CLI's tick metrics and
  ``verify_log``: equal.
* the port against itself (a request alone and packed, chunk sizes,
  bucketed and chunked prefill): tokens equal, and KV rows equal bit for
  bit where stated.
"""
import dataclasses
import doctest
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
from conftest import CACHE_LEN, CHUNK
from repro import configs as rconfigs
from repro.models import attention as RA
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.serve import scheduler as RS
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro.serve.serve_step import cache_abstract as r_cache_abstract
from repro_torch import configs
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as TA
from repro_torch.models import (abstract_params, decode_step, extend_step,
                                init_params, params_from_reference, prefill)
from repro_torch.serve import scheduler as TS
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.crypto import CryptoContext, CryptoRequest
from repro_torch.serve.serve_step import (cache_zeros, make_decode_step,
                                          make_prefill)

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (arch, overrides): gemma3's ring cache and its masked linear lowering, a
# GQA llama, and gemma's int8 KV cache
SERVE_CONFIGS = {
    "gemma3_ring": ("gemma3-1b", {}),
    "gemma3_linear": ("gemma3-1b", {"window_cache": False}),
    "llama": ("llama3.2-3b", {}),
    "gemma_int8": ("gemma-2b", {"kv_quant": True}),
}


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


def T_(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(a, dtype=None):
    a = jnp.asarray(np.array(a))
    return a if dtype is None else a.astype(dtype)


def same_cache(got: dict, want: dict):
    """Every leaf by name, shape, dtype and value (the module's bounds);
    jit returns the reference's dicts with their keys sorted."""
    assert sorted(got) == sorted(want), (list(got), list(want))
    for name, w in want.items():
        if name == "len":
            assert got[name] == int(np.asarray(w)), name
            continue
        g = got[name]
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        if g.dtype == torch.int8:
            off = np.abs(g.numpy().astype(np.int64) - np.asarray(w))
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, name
        else:
            close(g, np.asarray(w))


def configs_pair(key):
    name, kw = SERVE_CONFIGS[key]
    return (dataclasses.replace(rconfigs.get_config(name).smoke(), **kw),
            dataclasses.replace(configs.get_config(name).smoke(), **kw))


def reference_params(rc, tc, seed=0):
    rp = r_init_params(rc, jax.random.key(seed))
    return rp, params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), "cpu")


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("sq", [1, 4])
@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_decode_attention_matches_reference(rows, sq, window, dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(10)
    b, S, h, g, hd = 3, 24, 4, 2, 16
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, S, g, hd)).astype(np.float32)
            for _ in range(2))
    cur = 17 if rows == "scalar" else np.array([5, 17, 24], np.int64)
    want = RA.decode_attention(J(q, jd), J(k, jd), J(v, jd), J(cur),
                               window=window)
    got = TA.decode_attention(T_(q, td), T_(k, td), T_(v, td),
                              cur if rows == "scalar" else T_(cur),
                              window=window)
    assert got.dtype == td
    close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("rows", ["scalar", "per_row"])
def test_decode_attention_int8_scales_match_reference(rows):
    """The int8 branch: q stays f32, the cache is cast to it, and the
    (b, g) scales multiply after each contraction."""
    rng = np.random.default_rng(11)
    b, S, h, g, hd = 2, 16, 4, 2, 16
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k, v = (rng.integers(-127, 128, (b, S, g, hd)).astype(np.int8)
            for _ in range(2))
    ks, vs = (0.01 + 0.02 * rng.random((b, g)).astype(np.float32)
              for _ in range(2))
    cur = 9 if rows == "scalar" else np.array([3, 16], np.int64)
    want = RA.decode_attention(J(q), J(k), J(v), J(cur), kscale=J(ks),
                               vscale=J(vs))
    got = TA.decode_attention(T_(q), T_(k), T_(v),
                              cur if rows == "scalar" else T_(cur),
                              kscale=T_(ks), vscale=T_(vs))
    close(got, want)


@pytest.mark.parametrize("pos", [5, 15, 16, 37])
def test_decode_attention_ring_matches_reference(pos):
    """A ring of W = 16 slots before it fills (pos < W) and after it wraps
    (pos >= W: the slots hold positions pos - ((pos - slot) mod W))."""
    rng = np.random.default_rng(12)
    b, W, h, g, hd = 2, 16, 4, 1, 16
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, W, g, hd)).astype(np.float32)
            for _ in range(2))
    want = RA.decode_attention_ring(J(q), J(k), J(v), jnp.int32(pos))
    close(TA.decode_attention_ring(T_(q), T_(k), T_(v), pos), want)


ATTN_DECODE_CALLS = {
    # name: (new tokens a row, positions, ring, window)
    "scalar": (1, 11, False, None),
    "per_row": (1, [3, 11, 0], False, 6),
    "chunk": (4, [0, 8, 20], False, None),
    "ring": (1, 21, True, None),
}


@pytest.mark.parametrize("call", ATTN_DECODE_CALLS)
def test_attn_decode_matches_reference(call):
    """The four call shapes: one token at one position, one token a row at
    its own position, a chunk of 4 a row, and a ring of W = 16 past its
    wrap.  The output and the written cache are compared."""
    s, pos, ring, window = ATTN_DECODE_CALLS[call]
    rng = np.random.default_rng(13)
    b, S, d, h, g, hd = 3, 16 if ring else 24, 32, 4, 2, 16
    p = {"wq": 0.2 * rng.standard_normal((d, h, hd)),
         "wk": 0.2 * rng.standard_normal((d, g, hd)),
         "wv": 0.2 * rng.standard_normal((d, g, hd)),
         "wo": 0.2 * rng.standard_normal((h, hd, d))}
    p = {k: w.astype(np.float32) for k, w in p.items()}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, S, g, hd)).astype(np.float32)
              for _ in range(2))
    kw = dict(heads=h, kv=g, hd=hd, theta=1e4, ring=ring, window=window)
    rpos = J(np.asarray(pos, np.int32))
    want, wcache = RA.attn_decode({k: J(w) for k, w in p.items()}, J(x),
                                  {"k": J(kc), "v": J(vc)}, rpos, **kw)
    cache = {"k": T_(kc), "v": T_(vc)}
    got, gcache = TA.attn_decode({k: T_(w) for k, w in p.items()}, T_(x),
                                 cache, pos, **kw)
    close(got, want)
    assert gcache["k"] is cache["k"]          # written in place
    for name in ("k", "v"):
        close(gcache[name], wcache[name])


def test_attn_decode_refuses_a_write_outside_the_row():
    """XLA would clamp the update's start and shift it over earlier
    positions; the port refuses the write (host positions are checked)."""
    b, S, d, h, g, hd = 2, 8, 16, 2, 1, 8
    p = {"wq": torch.zeros(d, h, hd), "wk": torch.zeros(d, g, hd),
         "wv": torch.zeros(d, g, hd), "wo": torch.zeros(h, hd, d)}
    cache = {"k": torch.zeros(b, S, g, hd), "v": torch.zeros(b, S, g, hd)}
    kw = dict(heads=h, kv=g, hd=hd, theta=1e4)
    for x, pos in ((torch.zeros(b, 2, d), 7), (torch.zeros(b, 1, d), -1),
                   (torch.zeros(b, 4, d), [0, 5]),
                   (torch.zeros(b, 1, d), np.array([8, 0]))):
        with pytest.raises(ValueError, match="leaves the cache row"):
            TA.attn_decode(p, x, cache, pos, **kw)
    assert not cache["k"].any()


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("key", SERVE_CONFIGS)
def test_prefill_decode_extend_match_reference(key):
    """prefill of two 80-token prompts into a 128-position cache, 8 decode
    steps at one position, then (on linear caches) an extend of a 4-token
    chunk at per-row positions reading one logit position, and a decode
    step at per-row positions.  Logits and every cache leaf compared after
    each call; gemma3's 80 tokens are past its smoke window (64), so its
    ring has wrapped."""
    rc, tc = configs_pair(key)
    rp, tp = reference_params(rc, tc)
    rng = np.random.default_rng(14)
    toks = rng.integers(0, rc.vocab, (2, 80), dtype=np.int32)
    S = 128
    want, wc = jax.jit(lambda p, t: r_prefill(rc, p, {"tokens": t}, S))(
        rp, J(toks))
    got, gc = prefill(tc, tp, {"tokens": T_(toks)}, S)
    close(got, want)
    same_cache(gc, wc)
    r_dec = jax.jit(lambda p, c, t, pos: r_decode_step(rc, p, c, t, pos))
    for pos in range(80, 88):
        t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
        want, wc = r_dec(rp, wc, J(t), jnp.int32(pos))
        got, gc = decode_step(tc, tp, gc, T_(t), pos)
        close(got, want)
    same_cache(gc, wc)
    chunk = rng.integers(0, rc.vocab, (2, 4), dtype=np.int32)
    rows = np.array([88, 100], np.int32)
    if "lk" in gc:
        with pytest.raises(NotImplementedError, match="ring caches"):
            extend_step(tc, tp, gc, T_(chunk), rows, logit_index=2)
        return
    want, wc = jax.jit(lambda p, c, t, pos: r_extend_step(
        rc, p, c, t, pos, logit_index=2))(rp, wc, J(chunk), J(rows))
    got, gc = extend_step(tc, tp, gc, T_(chunk), rows, logit_index=2)
    assert tuple(got.shape) == (2, 1, tc.vocab)
    close(got, want)
    same_cache(gc, wc)
    t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
    want, wc = r_dec(rp, wc, J(t), J(rows + 4))
    got, gc = decode_step(tc, tp, gc, T_(t), rows + 4)
    close(got, want)
    same_cache(gc, wc)


def test_extend_all_positions_and_make_steps_match_reference():
    """extend_step without ``logit_index`` unembeds every chunk position;
    ``make_prefill``/``make_decode_step`` are the reference's wrappers."""
    rc, tc = configs_pair("llama")
    rp, tp = reference_params(rc, tc)
    rng = np.random.default_rng(15)
    toks = rng.integers(0, rc.vocab, (1, 12), dtype=np.int32)
    _, wc = jax.jit(lambda p, t: r_prefill(rc, p, {"tokens": t}, 32))(
        rp, J(toks))
    _, gc = make_prefill(tc, 32)(tp, {"tokens": T_(toks)})
    chunk = rng.integers(0, rc.vocab, (1, 8), dtype=np.int32)
    want, wc = jax.jit(lambda p, c, t: r_extend_step(rc, p, c, t, 12))(
        rp, wc, J(chunk))
    got, gc = extend_step(tc, tp, gc, T_(chunk), 12)
    assert tuple(got.shape) == (1, 8, tc.vocab)
    close(got, want)
    same_cache(gc, wc)
    want, _ = jax.jit(lambda p, c: r_decode_step(rc, p, c, J([[3]]), 20))(
        rp, wc)
    close(make_decode_step(tc)(tp, gc, T_([[3]]), 20)[0], want)


def test_unknown_family_raises_value_error_as_the_reference_does():
    """A family no dispatcher knows: ``ValueError`` naming it from every
    entry point, as the reference's ``models/model.py`` raises it."""
    rc = dataclasses.replace(rconfigs.get_config("mamba2-370m").smoke(),
                             family="rnn")
    tc = dataclasses.replace(configs.get_config("mamba2-370m").smoke(),
                             family="rnn")
    toks = np.ones((1, 4), np.int32)
    calls = [
        (lambda: r_prefill(rc, {}, {"tokens": J(toks)}, 16),
         lambda: prefill(tc, {}, {"tokens": T_(toks)}, 16)),
        (lambda: r_decode_step(rc, {}, {}, J(toks[:, :1]), 4),
         lambda: decode_step(tc, {}, {}, T_(toks[:, :1]), 4)),
        (lambda: r_init_params(rc, jax.random.key(0)),
         lambda: init_params(tc, 0, "cpu")),
    ]
    for want_fn, got_fn in calls:
        with pytest.raises(ValueError) as want:
            want_fn()
        with pytest.raises(ValueError) as got:
            got_fn()
        assert str(got.value) == str(want.value) == "rnn"


@pytest.mark.parametrize("key", SERVE_CONFIGS)
@pytest.mark.parametrize("batch,cache_len", [(1, 64), (3, 128)])
def test_cache_zeros_matches_cache_abstract(key, batch, cache_len):
    """The leaves, shapes and dtypes of the reference's ``cache_abstract``
    (an eval_shape of its prefill), reckoned without running one."""
    rc, tc = configs_pair(key)
    want = r_cache_abstract(rc, jax.eval_shape(
        lambda: r_init_params(rc, jax.random.key(0))), batch, cache_len)
    got = cache_zeros(tc, batch, cache_len, "cpu")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name == "len":
            assert got[name] == 0
            continue
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
        assert not got[name].any()


# ------------------------------------------------------------- scheduler
def test_slot_scheduler_matches_reference():
    """One seeded sequence of submits, admissions, tokens and retirements
    through both schedulers: equal slot states, rows (idle rows parked at
    cache_len - 1) and completions after every operation."""
    rng = np.random.default_rng(16)
    sch = {"r": RS.SlotScheduler(3, 24), "t": TS.SlotScheduler(3, 24)}
    mods = {"r": RS, "t": TS}

    def state(s):
        return ([(x.index, x.state, x.next_pos, x.last_token,
                  None if x.req is None else x.req.rid) for x in s.slots],
                s.step_rows(), s.pending, s.busy,
                [(r.rid, r.out, r.t_admit, r.t_first, r.t_done)
                 for r in s.completed])

    rid = 0
    for tick in range(60):
        op = rng.integers(0, 3)
        for k, s in sch.items():
            if op == 0 and rid < 10:
                s.submit(mods[k].Request(
                    rid=rid, prompt=[1] * int(1 + rid % 7),
                    max_new=int(2 + rid % 4),
                    eos=5 if rid % 3 == 0 else None))
            slot = s.admit_next(float(tick))
            if slot is not None:
                s.start_decode(slot, int(slot.req.rid) % 9, float(tick))
            for slot in s.decoding_slots():
                s.advance(slot)
                s.record_token(slot, int(tick * 7 + slot.index) % 9,
                               float(tick))
        rid += int(op == 0 and rid < 10)
        assert state(sch["t"]) == state(sch["r"]), tick
    assert len(sch["t"].completed) == 10
    parked = sch["t"].step_rows()[1]
    assert parked == [23, 23, 23]
    for bad in (dict(prompt=[], max_new=2), dict(prompt=[1], max_new=0),
                dict(prompt=[1] * 20, max_new=5)):
        errs = []
        for k, s in sch.items():
            with pytest.raises(ValueError) as e:
                s.submit(mods[k].Request(rid=99, **bad))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# --------------------------------------------------- engines across packages
@pytest.fixture(scope="module")
def models():
    """gemma-2b.smoke() in both packages, from the reference's params (the
    reference's serve suites' ``cfg``/``params`` fixtures)."""
    rc = rconfigs.get_config("gemma-2b").smoke()
    tc = configs.get_config("gemma-2b").smoke()
    rp, tp = reference_params(rc, tc)
    return rc, rp, tc, tp


def make_engine(tc, tp, **kw):
    """The reference's ``tests/conftest.py::make_engine`` geometry."""
    kw.setdefault("n_slots", 3)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("prefill_chunk", CHUNK)
    return ContinuousBatcher(tc, tp, **kw)


def requests(mod, vocab, seed=0):
    """``test_serve_batcher.py::_requests``: prompt lengths straddle the
    chunk (3 < 8 < 11)."""
    rng = np.random.default_rng(seed)
    mk = lambda rid, plen, max_new: mod.Request(
        rid=rid, prompt=[int(t) for t in rng.integers(1, vocab, plen)],
        max_new=max_new)
    return [mk(0, 5, 8), mk(1, 11, 7), mk(2, 3, 9)]


def kv_row(eng, slot, plen, n_out):
    """A request's written KV span [0, plen + n_out - 1)."""
    end = plen + n_out - 1
    return (eng.cache["k"][:, slot, :end].clone(),
            eng.cache["v"][:, slot, :end].clone())


def run_mixed(eng, reqs):
    """``test_serve_batcher.py::_run_mixed``: r0 streams alone, r1 joins
    mid-decode, then r2, all three overlapping before any retirement."""
    eng.submit(reqs[0])
    eng.try_admit()
    eng.step(), eng.step()
    eng.submit(reqs[1])
    eng.try_admit()
    eng.step()
    eng.submit(reqs[2])
    eng.try_admit()
    assert len(eng.sched.decoding_slots()) == 3
    while eng.sched.busy:
        eng.try_admit()
        eng.step()
    return eng


def test_engine_tokens_and_fingerprints_match_reference(models):
    """The mixed run of both engines under rns_verify (plus a one-token
    request that retires inside its admission): the same tokens for every
    request, the same slots, fingerprints to the f32 bound, and the same
    verify_log; the report's census keys and values are the reference's."""
    rc, rp, tc, tp = models
    out = {}
    for k, (Eng, mod, cfg, params) in {
            "r": (RBatcher, RS, rc, rp), "t": (ContinuousBatcher, TS, tc, tp),
    }.items():
        eng = Eng(cfg, params, n_slots=3, cache_len=CACHE_LEN,
                  prefill_chunk=CHUNK, rns_verify=True)
        reqs = requests(mod, cfg.vocab)
        run_mixed(eng, reqs)
        eng.submit(mod.Request(rid=9, prompt=[1, 2, 3], max_new=1))
        eng.run_to_completion()
        sizes = eng.jit_cache_sizes()
        fps = {r.rid: np.asarray(eng._fp_fn(eng.cache, r.slot_index,
                                            len(r.prompt)))
               for r in reqs}
        out[k] = ({r.rid: (r.out, r.slot_index) for r in
                   eng.sched.completed}, fps, dict(eng.verify_log), sizes)
    assert out["t"][0] == out["r"][0]
    for rid, want in out["r"][1].items():
        got = torch.from_numpy(out["t"][1][rid])
        close(got, want)
    assert out["t"][2] == out["r"][2] == {0: True, 1: True, 2: True, 9: True}
    assert out["t"][3] == out["r"][3] == {
        "decode": 1, "extend": 1, "insert": 1, "fingerprint": 1}


# ------------------------------------------------ the engine within the port
def test_mid_stream_admission_bitwise_vs_solo(models):
    _, _, tc, tp = models
    eng = run_mixed(make_engine(tc, tp), requests(TS, tc.vocab))
    mixed = {r.rid: r for r in eng.sched.completed}
    assert sorted(mixed) == [0, 1, 2]
    for r in requests(TS, tc.vocab):
        solo = make_engine(tc, tp)
        assert solo.run_to_completion() == []
        solo.submit(r)
        done = solo.run_to_completion()
        assert done[0].out == mixed[r.rid].out
        m = kv_row(eng, mixed[r.rid].slot_index, len(r.prompt), len(r.out))
        s = kv_row(solo, r.slot_index, len(r.prompt), len(r.out))
        for a, b in zip(m, s):
            assert torch.equal(a, b)


def test_prefill_chunk_size_is_bitwise_invisible(models):
    """Tokens equal for chunks of 4 and 16; the KV rows too, bit for bit."""
    _, _, tc, tp = models
    outs, rows = [], []
    for chunk in (4, 16):
        eng = make_engine(tc, tp, prefill_chunk=chunk)
        for r in requests(TS, tc.vocab):
            eng.submit(r)
        done = eng.run_to_completion()
        outs.append({r.rid: r.out for r in done})
        rows.append({r.rid: kv_row(eng, r.slot_index, len(r.prompt),
                                   len(r.out)) for r in done})
    assert outs[0] == outs[1]
    for rid in rows[0]:
        for a, b in zip(rows[0][rid], rows[1][rid]):
            assert torch.equal(a, b)


def test_slot_reuse_after_retirement(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2)
    rng = np.random.default_rng(3)
    for i in range(5):
        eng.submit(TS.Request(
            rid=i, prompt=[int(t) for t in rng.integers(1, tc.vocab, 4)],
            max_new=3 + i % 3))
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(len(r.out) == r.max_new for r in done)
    by_slot = {}
    for r in done:
        by_slot.setdefault(r.slot_index, []).append(r.rid)
    assert set(by_slot) <= {0, 1}
    assert max(len(v) for v in by_slot.values()) >= 2


def test_no_retrace_across_churn(models):
    _, _, tc, tp = models
    eng = run_mixed(make_engine(tc, tp), requests(TS, tc.vocab))
    assert eng.jit_cache_sizes() == {"decode": 1, "extend": 1, "insert": 1}


def test_idle_rows_write_only_at_the_parking_position(models):
    """A parked row's decode writes land at cache_len - 1 and nowhere else:
    the rest of an idle row is untouched while its neighbour decodes."""
    _, _, tc, tp = models
    eng = make_engine(tc, tp)
    eng.submit(TS.Request(rid=0, prompt=[4, 5, 6], max_new=6))
    eng.try_admit()
    idle_k = eng.cache["k"][:, 1:].clone()
    eng.step()
    after = eng.cache["k"][:, 1:]
    assert torch.equal(after[:, :, :CACHE_LEN - 1],
                       idle_k[:, :, :CACHE_LEN - 1])
    assert after[:, :, CACHE_LEN - 1].abs().sum() > 0   # the junk write


def test_eos_retires_early(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp)
    eng.submit(TS.Request(rid=0, prompt=[1, 2, 3], max_new=6))
    first = eng.run_to_completion()[0].out[0]
    eng2 = make_engine(tc, tp)
    eng2.submit(TS.Request(rid=1, prompt=[1, 2, 3], max_new=6, eos=first))
    assert eng2.run_to_completion()[0].out == [first]


def test_rns_verify_and_injected_corruption_repair(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, rns_verify=True)
    for r in requests(TS, tc.vocab):
        eng.submit(r)
    eng.submit(TS.Request(rid=9, prompt=[1, 2, 3], max_new=1))
    done = eng.run_to_completion()
    assert eng.verify_log == {r.rid: True for r in done}
    assert 9 in eng.verify_log
    assert all(eng.wire_ok(r.rid) for r in done)
    rid = done[0].rid
    stored = eng._wire[rid].residues.clone()
    eng.corrupt_wire(rid, channel=1, delta=3)
    assert not eng.wire_ok(rid)
    assert eng.repair_wire(rid) == {"repaired": 1, "unrecoverable": 0}
    assert eng.wire_ok(rid)
    assert torch.equal(eng._wire[rid].residues, stored)
    assert eng.jit_cache_sizes()["fingerprint"] == 1


def test_fingerprint_stays_valid_after_retirement(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, rns_verify=True)
    short = TS.Request(rid=0, prompt=[1, 2, 3], max_new=2)
    long = TS.Request(rid=1, prompt=[4, 5, 6], max_new=8)
    eng.submit(short), eng.submit(long)
    eng.try_admit()
    while short.t_done is None:
        eng.step()
    for _ in range(3):
        eng.step()
    assert eng.verify_request(short)


def test_drain_completed_releases_state(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, rns_verify=True)
    for r in requests(TS, tc.vocab):
        eng.submit(r)
    eng.run_to_completion()
    done = eng.drain_completed()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.sched.completed == [] and eng._wire == {}
    assert eng.verify_log == {}


@pytest.mark.parametrize("kw,match", [
    (dict(cache_len=30, prefill_chunk=8), "must divide"),
    (dict(cache_len=600, prefill_chunk=8), "multiple of 512"),
    (dict(prefill_buckets=()), "at least|>= 1 bucket"),
    (dict(prefill_buckets=(8, 40)), "out of range"),
    (dict(crypto_ctx=CryptoContext(n_limbs=3)), "crypto_slots"),
])
def test_constructor_errors_match_reference(models, kw, match):
    """Each refusal, with the reference's own message."""
    rc, rp, tc, tp = models
    with pytest.raises(ValueError, match=match) as got:
        make_engine(tc, tp, **kw)
    rkw = dict(kw)
    if "crypto_ctx" in rkw:
        from repro.serve.crypto import CryptoContext as RContext
        rkw["crypto_ctx"] = RContext(n_limbs=3)
    with pytest.raises(ValueError) as want:
        RBatcher(rc, rp, **{"n_slots": 3, "cache_len": CACHE_LEN,
                            "prefill_chunk": CHUNK, **rkw})
    assert str(got.value) == str(want.value)


def test_duplicate_rid_rejected_under_rns_verify(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, rns_verify=True)
    eng.submit(TS.Request(rid=7, prompt=[1, 2, 3], max_new=4))
    with pytest.raises(ValueError, match="already holds verify state"):
        eng.submit(TS.Request(rid=7, prompt=[4, 5, 6], max_new=4))
    assert [r.rid for r in eng.run_to_completion()] == [7]
    eng.drain_completed()
    eng.submit(TS.Request(rid=7, prompt=[1, 2], max_new=2))
    assert len(eng.run_to_completion()) == 1


def test_unsupported_families_are_gated():
    ssm = configs.get_config("mamba2-370m").smoke()
    with pytest.raises(NotImplementedError, match="linear-KV"):
        ContinuousBatcher(ssm, {}, n_slots=1, cache_len=16)
    quant = dataclasses.replace(configs.get_config("gemma-2b").smoke(),
                                kv_quant=True)
    with pytest.raises(NotImplementedError, match="int8"):
        ContinuousBatcher(quant, {}, n_slots=1, cache_len=16)


def test_oversized_request_fails_at_submit(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=1, cache_len=8, prefill_chunk=4)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(TS.Request(rid=0, prompt=[1] * 6, max_new=4))


def test_windowed_arch_lowers_to_masked_cache():
    """gemma3's grouped ring cache lowers to the linear masked layout, and
    the tokens are the reference engine's on the same parameters."""
    rc, tc = configs_pair("gemma3_ring")
    assert tc.window and tc.window_cache
    rp, tp = reference_params(rc, tc, seed=2)
    outs = []
    for Eng, mod, cfg, params in ((RBatcher, RS, rc, rp),
                                  (ContinuousBatcher, TS, tc, tp)):
        eng = Eng(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                  prefill_chunk=CHUNK)
        assert not eng.cfg.window_cache
        eng.submit(mod.Request(rid=0, prompt=[4, 5, 6, 7], max_new=4))
        outs.append(eng.run_to_completion()[0].out)
    assert len(outs[1]) == 4 and outs[1] == outs[0]
    assert tuple(eng.cache["k"].shape)[:3] == (tc.n_layers, 2, CACHE_LEN)


def test_bucketed_prefill_tokens_and_kv_equal_the_chunk_loop(models):
    """One padded extend per prompt against the chunk loop: equal tokens,
    and on this CPU build the prompt KV rows equal bit for bit too (the
    reference's rows differ by up to one ulp on jax 0.9.0)."""
    _, _, tc, tp = models
    runs = []
    for buckets in (None, (8, 16, CACHE_LEN)):
        eng = make_engine(tc, tp, prefill_buckets=buckets)
        for r in requests(TS, tc.vocab):
            eng.submit(r)
        done = eng.run_to_completion()
        runs.append(({r.rid: r.out for r in done},
                     {r.rid: kv_row(eng, r.slot_index, len(r.prompt), 1)
                      for r in done}, eng))
    assert runs[0][0] == runs[1][0]
    for rid in runs[0][1]:
        for a, b in zip(runs[0][1][rid], runs[1][1][rid]):
            assert torch.equal(a, b)
    eng = runs[1][2]
    assert eng.jit_cache_sizes()["extend"] == 2   # widths 8 and 16
    assert eng.bucket_stats() == {
        "widths": [8, 16, CACHE_LEN], "hits": {"8": 2, "16": 1, "32": 0},
        "fallbacks": 0, "pad_tokens": 3 + 5 + 5, "real_tokens": 19,
        "pad_overhead": 13 / 19}


def test_mixed_families_share_one_verify_log(models):
    """llm,crypto on one engine: crypto results equal Python's, one shared
    verify_log and wire store, and a rid is refused across families."""
    _, _, tc, tp = models
    ctx = CryptoContext(n_limbs=3, exp_bits=8)
    eng = make_engine(tc, tp, rns_verify=True, crypto_slots=2,
                      crypto_ctx=ctx, crypto_chunk=4)
    N = 1000003
    eng.submit(TS.Request(rid=0, prompt=[3, 1, 4], max_new=5))
    eng.submit(CryptoRequest(rid=1, op="modexp", a=7, b=200, n=N))
    eng.submit(CryptoRequest(rid=2, op="modmul", a=7, b=200, n=N))
    with pytest.raises(ValueError, match="rid 0 already holds"):
        eng.submit(CryptoRequest(rid=0, op="modmul", a=1, b=2, n=N))
    with pytest.raises(ValueError, match="rid 1 already holds"):
        eng.submit(TS.Request(rid=1, prompt=[1], max_new=1))
    done = {r.rid: r for r in eng.run_to_completion()}
    assert done[1].result == pow(7, 200, N) and done[2].result == 1400
    assert len(done[0].out) == 5
    assert eng.verify_log == {0: True, 1: True, 2: True}
    assert eng._crypto.verify_log is eng.verify_log
    assert eng._crypto.wire is eng.wire
    assert set(eng.wire.keys()) == {0, ("crypto", 1)}
    sizes = eng.jit_cache_sizes()
    assert sizes.pop("crypto_divmod") == 0        # never called
    assert set(sizes) == {"decode", "extend", "insert", "fingerprint",
                          "crypto_admit", "crypto_step", "crypto_final",
                          "crypto_modmul", "crypto_fingerprint"}
    assert set(sizes.values()) == {1}
    eng.drain_completed()
    assert eng.verify_log == {} and len(eng.wire) == 0
    with pytest.raises(ValueError, match="crypto_slots"):
        make_engine(tc, tp).submit(
            CryptoRequest(rid=3, op="modmul", a=1, b=2, n=N))


# ------------------------------------------------------------------ the CLI
SMOKE_ARGS = ["--arch", "gemma-2b", "--smoke", "--requests", "6", "--slots",
              "3", "--cache-len", "64", "--prefill-chunk", "8", "--max-new",
              "6", "--rns-verify", "--inject-wire-corrupt"]


def run_cli(module, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *argv], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=600)
    return out


def test_serve_cli_llm_matches_reference_cli(tmp_path):
    """The smoke command in both packages: the tick metrics (which depend on
    the workload, not on the weights) equal, the RRNS block equal, and each
    package's saved trace loads in the other."""
    got = run_cli("repro_torch.launch.serve",
                  ["--device", "cpu", *SMOKE_ARGS, "--save-trace",
                   str(tmp_path / "port.jsonl")], tmp_path)
    want = run_cli("repro.launch.serve",
                   [*SMOKE_ARGS, "--save-trace", str(tmp_path / "ref.jsonl")],
                   tmp_path)
    assert got.returncode == 0, got.stderr
    assert want.returncode == 0, want.stderr
    g, w = json.loads(got.stdout), json.loads(want.stdout)
    for key in ("arch", "engine", "n_slots", "cache_len", "requests",
                "tokens_out", "steps", "max_concurrency", "ttft_ticks",
                "latency_ticks", "jit_traces", "rns"):
        assert g[key] == w[key], key
    assert g["tokens_out"] == 36 and g["device"] == "cpu"
    assert g["rns"]["injected_repair"] == {"repaired": 1, "unrecoverable": 0}
    assert ((tmp_path / "port.jsonl").read_text()
            == (tmp_path / "ref.jsonl").read_text())
    rng = np.random.default_rng(0)
    key = lambda r: (r.rid, r.prompt, r.max_new, r.eos, r.arrival)
    from repro.launch.serve import load_trace as r_load_trace
    for path in ("port.jsonl", "ref.jsonl"):
        a = t_serve.load_trace(str(tmp_path / path), rng, 512)
        b = r_load_trace(str(tmp_path / path), rng, 512)
        assert [key(r) for r in a] == [key(r) for r in b]
    replay = run_cli("repro_torch.launch.serve",
                     ["--device", "cpu", *SMOKE_ARGS, "--trace",
                      str(tmp_path / "ref.jsonl")], tmp_path)
    assert replay.returncode == 0, replay.stderr
    r = json.loads(replay.stdout)
    assert {k: r[k] for k in ("steps", "ttft_ticks", "latency_ticks")} == \
        {k: g[k] for k in ("steps", "ttft_ticks", "latency_ticks")}


def test_crypto_trace_round_trips_across_packages(tmp_path):
    """A mixed trace with big ints: saved by the port, loaded by the
    reference, and back."""
    from repro.launch.serve import load_trace as r_load_trace
    from repro.launch.serve import save_trace as r_save_trace

    ctx = CryptoContext(n_limbs=5, exp_bits=32)
    rng = np.random.default_rng(5)
    reqs = t_serve.synth_requests(3, rng, 512, prompt_mean=6, max_new=4,
                                  arrival_rate=0.5)
    reqs += t_serve.synth_crypto_requests(3, rng, ctx, arrival_rate=0.5,
                                          rid0=3)
    t_serve.save_trace(str(tmp_path / "a.jsonl"), reqs)
    back = r_load_trace(str(tmp_path / "a.jsonl"), rng, 512)
    r_save_trace(str(tmp_path / "b.jsonl"), back)
    assert (tmp_path / "a.jsonl").read_text() == \
        (tmp_path / "b.jsonl").read_text()
    again = t_serve.load_trace(str(tmp_path / "b.jsonl"), rng, 512)
    key = lambda r: tuple(getattr(r, f, None) for f in
                          ("rid", "family", "op", "a", "b", "n", "prompt",
                           "arrival"))
    assert [key(r) for r in again] == [key(r) for r in reqs]


def test_synth_requests_match_reference():
    from repro.launch.serve import synth_requests as r_synth

    got = t_serve.synth_requests(5, np.random.default_rng(3), 512,
                                 prompt_mean=20, max_new=7,
                                 arrival_rate=0.5)
    want = r_synth(5, np.random.default_rng(3), 512, prompt_mean=20,
                   max_new=7, arrival_rate=0.5)
    key = lambda r: (r.rid, r.prompt, r.max_new, r.eos, r.arrival)
    assert [key(r) for r in got] == [key(r) for r in want]


def test_serve_cli_mixed_families_in_process(capsys):
    """--families defaults to the whole workload: LLM and crypto requests
    on one engine, every crypto result against the oracle."""
    report, engine = t_serve.main(
        ["--device", "cpu", "--requests", "3", "--slots", "2",
         "--crypto-slots", "2", "--crypto-requests", "4", "--crypto-limbs",
         "3", "--crypto-exp-bits", "8", "--crypto-chunk", "4",
         "--rns-verify"])
    assert json.loads(capsys.readouterr().out) == report
    assert report["requests"] == 7 and report["tokens_out"] == 3 * 16
    assert report["crypto"]["oracle_failed"] == 0
    assert report["crypto"]["oracle_ok"] == 4
    assert report["rns"]["slots_failed"] == 0
    assert report["rns"]["slots_verified"] == 7
    assert set(report["jit_traces"].values()) == {1}
    assert engine.crypto is not None and not engine.busy


WARM_ARGS = ["--arch", "gemma-2b", "--requests", "4", "--slots", "2",
             "--cache-len", "64", "--prefill-chunk", "8", "--page-size", "8",
             "--max-new", "4", "--prompt-mean", "10", "--rns-verify",
             "--seed", "3"]


def test_serve_cli_warm_restart_matches_reference_cli(tmp_path, capsys):
    """``--warm-restart`` twice in each package (the reference's
    ``test_serve_driver_warm_restart``): the cold run persists the retained
    pages, the second adopts them all and dedups against them; both
    packages' ``warm_restart`` blocks, page counters and tick metrics
    equal."""
    from repro.launch.serve import main as r_main

    port, ref = [], []
    for _ in range(2):
        port.append(t_serve.main(["--device", "cpu", *WARM_ARGS,
                                  "--warm-restart", str(tmp_path / "p")])[0])
        ref.append(r_main([*WARM_ARGS, "--warm-restart",
                           str(tmp_path / "r")]))
    cold, warm = port
    assert cold["warm_restart"] == {"restored": False,
                                    "pages_saved": cold["warm_restart"][
                                        "pages_saved"]}
    assert cold["warm_restart"]["pages_saved"] >= 1
    assert warm["warm_restart"]["restored"] is True
    assert warm["warm_restart"]["adopted"] == \
        cold["warm_restart"]["pages_saved"]
    assert warm["warm_restart"]["dropped"] == 0
    assert warm["paging"]["dedup_hits"] >= 1  # restart-surviving prefixes
    assert warm["rns"]["slots_failed"] == 0
    for got, want in zip(port, ref):
        assert got["warm_restart"] == want["warm_restart"]
        for k in ("steps", "ttft_ticks", "latency_ticks", "rns"):
            assert got[k] == want[k], k
        drop = ("fingerprints",)
        assert {k: v for k, v in got["paging"].items() if k not in drop} \
            == {k: v for k, v in want["paging"].items() if k not in drop}
    out = capsys.readouterr().out
    assert "# warm restart: adopted" in out and "persisted" in out


def test_serve_cli_warm_restart_in_a_subprocess(tmp_path):
    """Twice through ``python -m repro_torch.launch.serve``, with one RRNS
    channel of the persisted state corrupted between the runs: repaired
    at the checkpoint layer, every page adopted."""
    from repro_torch.train import checkpointer as cp

    argv = ["--device", "cpu", *WARM_ARGS, "--warm-restart",
            str(tmp_path / "w")]
    first = run_cli("repro_torch.launch.serve", argv, tmp_path)
    assert first.returncode == 0, first.stderr
    cp.inject_channel_corruption(str(tmp_path / "w" / "step_0"), leaf=0,
                                 channels=(1,))
    second = run_cli("repro_torch.launch.serve", argv, tmp_path)
    assert second.returncode == 0, second.stderr
    a = json.loads(first.stdout[first.stdout.index("\n{") + 1:])
    b = json.loads(second.stdout[second.stdout.index("\n{") + 1:])
    assert b["warm_restart"]["ckpt_repaired_leaves"] == 1
    assert b["warm_restart"]["adopted"] == a["warm_restart"]["pages_saved"]
    assert b["warm_restart"]["dropped"] == 0


@pytest.mark.parametrize("argv", [
    ["--warm-restart", "d"],                                 # no pages
    ["--warm-restart", "d", "--page-size", "8"],             # no verify
    ["--warm-restart", "d", "--page-size", "8", "--rns-verify",
     "--no-prefix-share"],
    ["--mode", "offline", "--page-size", "8", "--rns-verify",
     "--warm-restart", "d"],
])
def test_serve_cli_warm_restart_preconditions(argv, capsys):
    """The reference's preconditions, each refused by argparse."""
    with pytest.raises(SystemExit) as e:
        t_serve.main(["--device", "cpu", *argv])
    assert e.value.code != 0
    assert "--warm-restart" in capsys.readouterr().err


@pytest.mark.parametrize("mode", ["sim", "offline"])
def test_serve_cli_profiler_window(tmp_path, mode):
    """``--profile-*`` (the reference's ``test_serve_driver_profiler_window``):
    the window captures its steps (decode ticks in sim, loop iterations
    offline) into one non-empty Chrome trace under ``profile_serve_*``."""
    report, _ = t_serve.main([
        "--device", "cpu", "--mode", mode, "--arch", "gemma-2b",
        "--requests", "2", "--slots", "2", "--cache-len", "32",
        "--prefill-chunk", "8", "--max-new", "8", "--prompt-mean", "6",
        "--profile-start-step", "1", "--profile-steps", "2",
        "--profile-dir", str(tmp_path)])
    prof = report["profile"]
    assert prof["captured_steps"] == 2
    assert prof["artifact"] == str(tmp_path / f"profile_serve_{mode}")
    traces = [os.path.join(d, f) for d, _, fs in os.walk(prof["artifact"])
              for f in fs]
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_scheduler_and_serve_step_doctests():
    for name in ("repro_torch.serve.scheduler", "repro_torch.serve.serve_step"):
        import importlib

        res = doctest.testmod(importlib.import_module(name), verbose=False)
        assert res.attempted > 0 and res.failed == 0, name


def test_full_width_engine_shapes_on_meta():
    """The chip run's engine at full width, reckoned without allocating:
    gemma3-1b has 999,812,736 parameters (4.0 GB in f32); its serving pool
    of 8 x 2048 rows is (26, 8, 2048, 1, 256) bf16 a side, 26,624 bytes a
    token, 436,207,616 bytes, and the solo row 54,525,952."""
    cfg = configs.get_config("gemma3-1b")
    n = sum(t.numel() for t in
            jax.tree_util.tree_leaves(abstract_params(cfg)))
    assert n == 999_812_736
    lowered = dataclasses.replace(cfg, window_cache=False)
    pool = cache_zeros(lowered, 8, 2048, "meta")
    assert tuple(pool["k"].shape) == (26, 8, 2048, 1, 256)
    assert pool["k"].dtype == torch.bfloat16
    nbytes = lambda c: sum(c[k].numel() * c[k].element_size()
                           for k in ("k", "v"))
    assert nbytes(pool) == 436_207_616 == 16384 * 26624
    assert nbytes(cache_zeros(lowered, 1, 2048, "meta")) == 54_525_952
