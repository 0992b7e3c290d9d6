"""The port's encdec family (whisper-tiny: cross-attention, the encoder,
the decoder stack, its serving cache and the CLIs on it) against the
reference's.

The same seeded numpy inputs (tokens and stub frame embeddings) go to
``repro`` and to ``repro_torch``; models start from the reference's own
``init_params`` output, carried over with ``params_from_reference``.
Everything runs on the CPU at ``whisper-tiny.smoke()`` (2 encoder and 4
decoder layers, d 128, 32 frames).

Tolerances, by what is compared:

* f32 outputs and cache leaves: rtol 1e-5 plus an atol of 1e-5 times the
  largest magnitude (``test_torch_models.py``); the libraries sum matmuls
  in other orders, and the reference's flash attention takes its softmax
  in chunks.
* bf16 compute: an atol of 2**-5 times the largest magnitude and a mean
  absolute error under 2**-9 of it (``test_torch_models.py``).
* loss (f32): rtol 1e-5; each gradient leaf: rtol 1e-5 plus an atol of
  1e-5 times its largest magnitude (``test_torch_train.py``).
* the training CLI: the printed losses (4 decimals) within 1e-4.
* tokens, tick metrics, shapes, dtypes and messages: equal; the cache
  handed to a cross-attention decode comes back as the same object.
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
from repro.models import attention as RA
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import train_logits as r_train_logits
from repro.models import transformer as RT
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro.serve.serve_step import cache_abstract as r_cache_abstract
from repro.serve.serve_step import prompt_abstract as r_prompt_abstract
from repro.train.train_step import make_loss_fn as r_make_loss_fn
from repro_torch import configs
from repro_torch.dist._tree import flatten_named
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import (decode_step, extend_step,
                                params_from_reference, prefill, train_logits)
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.serve_step import cache_zeros, prompt_zeros
from repro_torch.train.train_step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
NAME = "whisper-tiny"
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


def start(**kw):
    """(reference cfg, port cfg, reference params, port params)."""
    rc = dataclasses.replace(rconfigs.get_config(NAME).smoke(), **kw)
    tc = dataclasses.replace(configs.get_config(NAME).smoke(), **kw)
    rp = r_init_params(rc, jax.random.key(0))
    return rc, tc, rp, params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), "cpu")


def batch(cfg, b, s, seed):
    """Seeded tokens (b, s) and frame embeddings (b, F, d), as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            "frames": rng.standard_normal(
                (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)}


def both(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


def akw(cfg):
    return dict(heads=cfg.n_heads, kv=cfg.n_kv, hd=cfg.head_dim,
                theta=cfg.rope_theta)


def layer(rp, tp, i=0):
    """Decoder layer i's cross-attention weights in both packages."""
    r = jax.tree_util.tree_map(lambda a: a[i], rp["dec_layers"]["cross_attn"])
    t = {k: v[i] for k, v in tp["dec_layers"]["cross_attn"].items()}
    return r, t


# -------------------------------------------------------- cross-attention
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_forward_matches_reference(dtype):
    """``attn_forward(enc=)``: q from x at positions 5.., k and v from 32
    encoder states, rope on q only, no mask."""
    rc, tc, rp, tp = start()
    ra, ta = layer(rp, tp)
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, rc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, rc.enc_frames, rc.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(5, 17), (2, 12))
    want = jax.jit(lambda x, e: RA.attn_forward(
        ra, x, jnp.asarray(pos), enc=e, **akw(rc)))(
        jnp.asarray(x).astype(jd), jnp.asarray(enc).astype(jd))
    got = TA.attn_forward(ta, torch.from_numpy(x).to(td),
                          torch.from_numpy(pos.copy()),
                          enc=torch.from_numpy(enc).to(td), **akw(tc))
    assert got.dtype == td
    close(got, want.astype(jnp.float32), dtype)


def test_cross_attention_decode_matches_reference():
    """``attn_decode(enc=)``: one token at position 9 attends to every
    encoder state, K/V projected from ``enc`` in the call; the cache comes
    back as it was handed in; a chunk or per-row positions are refused."""
    rc, tc, rp, tp = start()
    ra, ta = layer(rp, tp, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, rc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, rc.enc_frames, rc.d_model)).astype(
        np.float32)
    want, _ = RA.attn_decode(ra, jnp.asarray(x), None, 9,
                             enc=jnp.asarray(enc), **akw(rc))
    marker = {"k": torch.zeros(1)}
    got, cache = TA.attn_decode(ta, torch.from_numpy(x), marker, 9,
                                enc=torch.from_numpy(enc), **akw(tc))
    close(got, want)
    assert cache is marker
    for xx, pos in ((np.ones((2, 2, rc.d_model), np.float32), 9),
                    (x, np.array([3, 4]))):
        with pytest.raises(ValueError, match="one token"):
            TA.attn_decode(ta, torch.from_numpy(xx), None, pos,
                           enc=torch.from_numpy(enc), **akw(tc))


def test_encoder_matches_reference():
    rc, tc, rp, tp = start()
    frames = batch(rc, 2, 4, 3)["frames"]
    want = jax.jit(lambda p, f: RT.encode(rc, p, f))(rp, jnp.asarray(frames))
    got = TT.encode(tc, tp, torch.from_numpy(frames))
    close(got, want)


# ------------------------------------------------------------------ stack
@pytest.mark.parametrize("dtype", DTYPES)
def test_train_logits_match_reference(dtype):
    rc, tc, rp, tp = start(dtype=dtype)
    rb, tb = both(batch(rc, 2, 24, 4))
    want, waux = jax.jit(lambda p, b: r_train_logits(rc, p, b))(rp, rb)
    got, aux = train_logits(tc, tp, tb)
    assert tuple(got.shape) == (2, 24, tc.vocab)
    assert got.dtype == DTYPES[dtype][1] and float(aux) == float(waux) == 0
    close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_value_and_grad(remat):
    """Loss and every gradient leaf (the encoder's through the
    cross-attention) against ``jax.value_and_grad``."""
    rc, tc, rp, tp = start(remat=remat)
    rb, tb = both(batch(rc, 2, 25, 5))
    (rl, _), rg = jax.jit(jax.value_and_grad(r_make_loss_fn(rc),
                                             has_aux=True))(rp, rb)
    loss, _, aux, grads = value_and_grad(make_loss_fn(tc), tp, tb)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    assert float(aux) == 0.0
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(rg)}
    got = {n: g.numpy() for n, g in flatten_named(grads)}
    assert list(got) == list(want)
    assert np.abs(got["enc_layers/attn/wq"]).max() > 0
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


def test_prefill_and_decode_match_reference():
    """A prefill of 20 tokens beside 32 frames into a 32-position cache,
    then 6 decode steps from position 20: logits and every cache leaf
    (``k``, ``v``, ``enc``, ``len``) after each call."""
    rc, tc, rp, tp = start()
    rb, tb = both(batch(rc, 2, 20, 6))
    want, wc = jax.jit(lambda p, b: r_prefill(rc, p, b, 32))(rp, rb)
    got, gc = prefill(tc, tp, tb, 32)
    close(got, want)
    rng = np.random.default_rng(7)
    r_dec = jax.jit(lambda p, c, t, pos: r_decode_step(rc, p, c, t, pos))
    for pos in range(20, 27):
        assert sorted(gc) == sorted(wc) == ["enc", "k", "len", "v"]
        assert gc["len"] == int(wc["len"]) == pos
        for n in ("k", "v", "enc"):
            close(gc[n], np.asarray(wc[n]))
        if pos == 26:
            break
        t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
        want, wc = r_dec(rp, wc, jnp.asarray(t), jnp.int32(pos))
        got, gc = decode_step(tc, tp, gc, torch.from_numpy(t), pos)
        close(got, want)


@pytest.mark.parametrize("batch_,cache_len", [(1, 64), (3, 128)])
def test_cache_and_prompt_zeros_match_the_abstract_ones(batch_, cache_len):
    """``cache_zeros`` against ``cache_abstract`` and ``prompt_zeros``
    against ``prompt_abstract`` (its ``frames`` entry): leaves, shapes,
    dtypes."""
    rc, tc = (rconfigs.get_config(NAME).smoke(),
              configs.get_config(NAME).smoke())
    pairs = [(cache_zeros(tc, batch_, cache_len, "cpu"), r_cache_abstract(
        rc, jax.eval_shape(lambda: r_init_params(rc, jax.random.key(0))),
        batch_, cache_len)),
        (prompt_zeros(tc, batch_, cache_len, "cpu"),
         r_prompt_abstract(rc, batch_, cache_len))]
    for got, want in pairs:
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            if n == "len":
                assert got[n] == 0
                continue
            assert tuple(got[n].shape) == tuple(w.shape), n
            assert str(got[n].dtype).split(".")[-1] == str(w.dtype), n
            assert not got[n].any()


def message(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def test_extend_paging_and_the_engine_refuse_as_the_reference_does():
    rc, tc, rp, tp = start()
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
    assert "'encdec'" in got


# ------------------------------------------------------------------ CLIs
def test_single_shot_serving_matches_reference():
    """``simulate_single_shot`` on the same requests, parameters and numpy
    generator state: the frames are drawn per request in the reference's
    place, so the tokens, tick stamps and counters agree and both
    generators are left in the same state."""
    rc, tc, rp, tp = start()
    out = {}
    for k, (mod, cfg, params, extra) in {
            "r": (r_serve, rc, rp, ()), "t": (t_serve, tc, tp, ("cpu",)),
    }.items():
        rng = np.random.default_rng(5)
        reqs = mod.synth_requests(3, rng, cfg.vocab, prompt_mean=12,
                                  max_new=5, arrival_rate=0.5)
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


def test_single_shot_cli_matches_reference_cli(tmp_path):
    """The serve CLI on whisper-tiny's smoke config in both packages: the
    same two ``#`` lines, then the report: single-shot engine, one slot,
    the tick metrics equal."""
    argv = ["--arch", NAME, "--requests", "3", "--max-new", "4",
            "--prompt-mean", "10"]
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
    assert g["engine"] == "single-shot" and g["tokens_out"] == 12


@pytest.mark.parametrize("flags", [["--rns-verify"],
                                   ["--crypto-slots", "2"]])
def test_single_shot_refuses_the_engine_only_paths(flags):
    with pytest.raises(NotImplementedError, match="'encdec'"):
        t_serve.main(["--device", "cpu", "--arch", NAME, "--requests", "1",
                      *flags])


def test_training_cli_matches_the_reference_cli(monkeypatch, capsys):
    """Three ``--rns-allreduce`` steps of the training CLIs from the same
    parameters: the frames come from ``SyntheticLM`` alike; the losses
    agree."""
    argv = ["--arch", NAME, "--steps", "3", "--batch", "2", "--seq", "16",
            "--rns-allreduce"]
    r_train.main(list(argv))
    want = [float(x) for x in re.findall(r"step +\d+ loss=([-\d.]+)",
                                         capsys.readouterr().out)]
    rc = rconfigs.get_config(NAME).smoke()
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_init_params(rc, jax.random.key(0)))
    monkeypatch.setattr(t_train, "init_params",
                        lambda cfg, seed, device: params_from_reference(
                            cfg, tree, device))
    params, summary = t_train.main(["--device", "cpu", *argv])
    assert len(want) == 3
    np.testing.assert_allclose(summary["losses"], want, rtol=0, atol=1e-4)
    assert all(bool(torch.isfinite(p).all()) for _, p in flatten_named(params))
