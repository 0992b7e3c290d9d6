"""The port's vlm family (the patch prefix of the transformer stack, the
training loss, and the serve CLI's single-shot path) against the
reference's.

The same seeded numpy inputs (tokens and patch embeddings) go to ``repro``
and to ``repro_torch``; models start from the reference's own
``init_params`` output, carried over with ``params_from_reference``.
Everything runs on the CPU at ``internvl2-26b.smoke()`` (16 patches, d 128).

Tolerances, by what is compared:

* f32 logits and K/V cache rows: rtol 1e-5 plus an atol of 1e-5 times the
  largest magnitude, as in ``test_torch_models.py`` (the libraries sum
  matmuls in other orders).
* bf16 logits: an atol of 2**-5 times the largest magnitude and a mean
  absolute error under 2**-9 of it (``test_torch_models.py``).
* loss and gradients (f32): rtol 1e-5, and for each gradient leaf an atol
  of 1e-5 times its largest magnitude (``test_torch_train.py``).
* tokens, the single-shot tick metrics, the report's keys and the refusal
  messages: equal.
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
from repro import configs as rconfigs
from repro.launch import serve as r_serve
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.models import prefill as r_prefill
from repro.models import train_logits as r_train_logits
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro.train.train_step import make_loss_fn as r_make_loss_fn
from repro_torch import configs
from repro_torch.dist._tree import flatten_named
from repro_torch.launch import serve as t_serve
from repro_torch.models import (decode_step, extend_step,
                                params_from_reference, prefill, train_logits)
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.train.train_step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
NAME = "internvl2-26b"
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
    """Seeded tokens (b, s) and patch embeddings (b, P, d), as numpy."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32),
            "patches": rng.standard_normal(
                (b, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def both(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_logits_with_patches_match_reference(dtype):
    """Logits over the text positions only, behind 16 patches cast to the
    compute dtype."""
    rc, tc, rp, tp = start(dtype=dtype)
    rb, tb = both(batch(rc, 2, 24, 1))
    want, waux = jax.jit(lambda p, b: r_train_logits(rc, p, b))(rp, rb)
    got, aux = train_logits(tc, tp, tb)
    assert tuple(got.shape) == (2, 24, tc.vocab)
    assert got.dtype == DTYPES[dtype][1] and float(aux) == float(waux) == 0
    close(got, want.astype(jnp.float32), dtype)


def test_loss_and_gradients_match_value_and_grad():
    """The training loss and every gradient leaf against
    ``jax.value_and_grad``; the batch carries the patches."""
    rc, tc, rp, tp = start()
    rb, tb = both(batch(rc, 2, 25, 2))
    (rl, _), rg = jax.jit(jax.value_and_grad(r_make_loss_fn(rc),
                                             has_aux=True))(rp, rb)
    loss, _, _, grads = value_and_grad(make_loss_fn(tc), tp, tb)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(rg)}
    got = {n: t.numpy() for n, t in flatten_named(grads)}
    assert list(got) == list(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=n)


def test_prefill_and_decode_with_patches_match_reference():
    """A prefill of 16 patches + 20 tokens into a 48-position cache (the
    patches at positions 0..15), then 4 decode steps from position 36:
    logits and every cache leaf after each call."""
    rc, tc, rp, tp = start()
    nb = batch(rc, 2, 20, 3)
    rb, tb = both(nb)
    S = 48
    want, wc = jax.jit(lambda p, b: r_prefill(rc, p, b, S))(rp, rb)
    got, gc = prefill(tc, tp, tb, S)
    close(got, want)
    assert gc["len"] == int(wc["len"]) == 36
    rng = np.random.default_rng(4)
    r_dec = jax.jit(lambda p, c, t, pos: r_decode_step(rc, p, c, t, pos))
    for pos in range(36, 40):
        for n in ("k", "v"):
            close(gc[n], np.asarray(wc[n]))
        t = rng.integers(0, rc.vocab, (2, 1), dtype=np.int32)
        want, wc = r_dec(rp, wc, jnp.asarray(t), jnp.int32(pos))
        got, gc = decode_step(tc, tp, gc, torch.from_numpy(t), pos)
        close(got, want)
    assert gc["len"] == int(wc["len"]) == 40


def message(fn):
    """The message ``fn`` raises NotImplementedError with."""
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def test_extend_paging_and_the_engine_refuse_vlm_as_the_reference_does():
    """``extend_step``, a paged ``decode_step`` and the continuous batcher
    refuse vlm with the reference's messages."""
    rc, tc, rp, tp = start()
    toks = np.ones((1, 4), np.int32)
    pages = np.zeros((1, 2), np.int32)
    got = message(lambda: extend_step(tc, tp, {}, torch.from_numpy(toks), 0))
    assert got == message(lambda: r_extend_step(rc, rp, {}, toks, 0))
    assert "extend_step supports text-only" in got
    tok = torch.from_numpy(toks[:, :1])
    got = message(lambda: decode_step(tc, tp, {}, tok, 0, pages=pages,
                                      page_size=8))
    assert got == message(lambda: r_decode_step(
        rc, rp, {}, toks[:, :1], 0, pages=pages, page_size=8))
    assert "paged decode supports text-only" in got
    got = message(lambda: ContinuousBatcher(tc, tp, n_slots=1, cache_len=16))
    assert got == message(lambda: RBatcher(rc, rp, n_slots=1, cache_len=16))
    assert "'vlm'" in got


def test_single_shot_serving_matches_reference():
    """``simulate_single_shot`` on the same requests, parameters and numpy
    generator state: the same tokens, tick stamps and counters, and both
    generators left in the same state (the patches drawn alike)."""
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
    assert out["t"][1] == out["r"][1] == {"steps": out["t"][1]["steps"],
                                         "max_concurrency": 1}
    assert np.array_equal(out["t"][2], out["r"][2])


def run_cli(module, argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if module.startswith("repro_torch") else []
    return subprocess.run([sys.executable, "-m", module, *extra, *argv],
                          env=env, cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)


def test_single_shot_cli_matches_reference_cli(tmp_path):
    """The serve CLI on internvl2's smoke config in both packages: the same
    two ``#`` lines, then the report: single-shot engine, one slot, and the
    tick metrics equal; no census."""
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
    assert g["engine"] == "single-shot" and g["n_slots"] == 1
    assert g["tokens_out"] == 12 and g["device"] == "cpu"
    assert "jit_traces" not in g and "jit_traces" not in w


@pytest.mark.parametrize("flags", [["--rns-verify"],
                                   ["--crypto-slots", "2"]])
def test_single_shot_refuses_the_engine_only_paths(flags):
    """``--rns-verify`` and the crypto lane need the slot engine: on vlm
    the engine's refusal propagates, as in the reference CLI."""
    with pytest.raises(NotImplementedError, match="'vlm'"):
        t_serve.main(["--device", "cpu", "--arch", NAME, "--requests", "1",
                      *flags])
