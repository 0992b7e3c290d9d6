"""The port's configs, layers, attention and dense decoder-only model
(``repro_torch.configs``, ``repro_torch.models``) and its data pipeline
(``repro_torch.train.data``) against the reference's.

Every comparison feeds the same seeded numpy inputs (and, for the model, the
reference's own ``init_params`` output through ``params_from_reference``)
to ``repro`` and to ``repro_torch``.

Tolerances, by what is compared:

* configs, ``shape_cells``, ``abstract_params`` shapes, ``SyntheticLM``
  batches: equal.
* f32 compute: rtol 1e-5 plus an atol of 1e-5 times the largest magnitude
  (2e-5 for gradients).  The two libraries sum matmuls and reductions in
  other orders, and the port's attention takes the softmax over whole rows
  where the reference's flash attention takes it chunk by chunk (an online
  rescale).
* bf16 compute: an atol of 2**-5 times the largest magnitude (four bf16
  ulps at it) and a mean absolute error under 2**-9 of it.  Each library
  rounds its bf16 elementwise chains at other places (XLA keeps excess
  precision inside fusions), so single elements move by a few ulps while
  the mean stays far below one.
* ``embed``: equal bit for bit in both dtypes.  The sqrt(d) scale is taken
  in the compute dtype, as the reference takes it; in bf16 that scale is
  34.0 at d = 1152, where an f32 33.94 would change many products.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro import configs as rconfigs
from repro.models import abstract_params as r_abstract_params
from repro.models import init_params as r_init_params
from repro.models import layers as R
from repro.models import train_logits as r_train_logits
from repro.models.attention import flash_attention
from repro.train.data import SyntheticLM as RSyntheticLM
from repro_torch import configs
from repro_torch.dist._tree import flatten_named
from repro_torch.models import (
    abstract_params,
    init_params,
    params_from_reference,
    train_logits,
)
from repro_torch.models import layers as T
from repro_torch.models.attention import attention
from repro_torch.models.config import PORT_FIELDS
from repro_torch.train.data import SyntheticLM

ROOT = Path(__file__).resolve().parents[1]
DENSE = ["gemma3-1b", "gemma-2b", "gemma-7b", "llama3.2-3b"]
ARCH_IDS = list(rconfigs.ALIASES)
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


def T_(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def J(a, dtype=None):
    a = jnp.asarray(np.array(a))
    return a if dtype is None else a.astype(dtype)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ARCH_IDS)
def test_configs_and_smoke_equal_reference(name):
    """Every field of the reference's config, of the arch and of its
    smoke(), equal; the port's own fields (``PORT_FIELDS``) are no others
    and stand at their defaults, which run the reference's model."""
    rc, tc = rconfigs.get_config(name), configs.get_config(name)
    defaults = {f.name: f.default for f in dataclasses.fields(tc)
                if f.name in PORT_FIELDS}
    for t, r in ((tc, rc), (tc.smoke(), rc.smoke())):
        got, want = dataclasses.asdict(t), dataclasses.asdict(r)
        assert set(got) - set(want) == set(PORT_FIELDS)
        assert {k: got[k] for k in want} == want
        assert {k: got[k] for k in PORT_FIELDS} == defaults
    assert configs.shape_cells(tc) == rconfigs.shape_cells(rc)
    for prop in ("d_inner", "ssm_heads", "q_per_kv"):
        assert getattr(tc, prop) == getattr(rc, prop)


def test_registry_tables_equal_reference():
    assert configs.ARCHS == rconfigs.ARCHS
    assert configs.ALIASES == rconfigs.ALIASES
    assert configs.SHAPES == rconfigs.SHAPES
    for v in (1, 127, 128, 129, 92553, 262144):
        assert configs.pad_vocab(v) == rconfigs.pad_vocab(v)
    # module names resolve as well as the CLI ids
    assert configs.get_config("gemma3_1b") == configs.get_config("gemma3-1b")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_rope_match_reference(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 96, 3, 64)).astype(np.float32)
    scale = 0.1 * rng.standard_normal(64).astype(np.float32)
    close(T.rms_norm(T_(x, td), T_(scale), 1e-6),
          R.rms_norm(J(x, jd), J(scale), 1e-6).astype(jnp.float32), dtype)
    # positions as the models feed them.  XLA's f32 exp and torch's differ
    # by an ulp on some frequencies, so an angle's error grows with the
    # position; at positions past 1000 it leaves the f32 bound.
    pos = np.broadcast_to(np.arange(96), (2, 96))
    for theta in (1e4, 5e5, 1e6):
        close(T.rope(T_(x, td), T_(pos), theta),
              R.rope(J(x, jd), J(pos), theta).astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_gated_mlp_matches_reference(act, dtype):
    """geglu's GELU is the tanh form (``jax.nn.gelu``'s default); torch's
    default erf form falls outside the f32 bound here."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    wi = 0.2 * rng.standard_normal((64, 2, 96)).astype(np.float32)
    wo = 0.2 * rng.standard_normal((96, 64)).astype(np.float32)
    want = R.gated_mlp(J(x, jd), J(wi), J(wo), act).astype(jnp.float32)
    close(T.gated_mlp(T_(x, td), T_(wi), T_(wo), act), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_is_bitwise_and_unembed_matches_reference(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(3)
    table = 0.02 * rng.standard_normal((512, 1152)).astype(np.float32)
    toks = rng.integers(0, 512, (2, 64)).astype(np.int32)
    want = np.asarray(R.embed(J(toks), J(table), jd).astype(jnp.float32))
    got = T.embed(T_(toks).long(), T_(table), td).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    x = rng.standard_normal((2, 8, 1152)).astype(np.float32)
    close(T.unembed(T_(x, td), T_(table)),
          R.unembed(J(x, jd), J(table)).astype(jnp.float32), dtype)


# --------------------------------------------------------------- attention
# (heads, kv heads, window, chunk): causal in one chunk and in four; a window
# longer than the chunk; GQA with one and with two KV heads; a window
# shorter than the chunk (8 < 32), where the reference skips whole chunks
ATTN_CASES = {
    "causal": (4, 4, None, 64),
    "causal_chunked": (4, 4, None, 16),
    "window": (4, 4, 24, 16),
    "gqa_g1": (4, 1, None, 16),
    "gqa_g2": (4, 2, 40, 16),
    "window_lt_chunk": (4, 2, 8, 32),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_forward_and_grads_match_flash_attention(case, dtype):
    """Against the reference's ``flash_attention(impl="vjp")`` (its
    hand-written flash backward): the output and dq, dk, dv under one
    random cotangent."""
    h, g, window, chunk = ATTN_CASES[case]
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(4)
    b, s, hd = 2, 64, 32
    q, k, v = (rng.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, g, g))
    ct = rng.standard_normal((b, s, h, hd)).astype(np.float32)

    def ref(q, k, v):
        return flash_attention(q, k, v, causal=True, window=window,
                               q_chunk=chunk, kv_chunk=chunk, impl="vjp")

    out, vjp = jax.vjp(ref, J(q, jd), J(k, jd), J(v, jd))
    grads = vjp(J(ct, jd))
    tq, tk, tv = (T_(a, td).requires_grad_() for a in (q, k, v))
    got = attention(tq, tk, tv, causal=True, window=window)
    got.backward(T_(ct, td))
    close(got, out.astype(jnp.float32), dtype)
    for t, want in zip((tq, tk, tv), grads):
        close(t.grad, want.astype(jnp.float32), dtype, rtol=2e-5)


# ------------------------------------------------------------------- model
def reference_params(rc, tc):
    rp = r_init_params(rc, jax.random.key(0))
    return rp, params_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, rp), "cpu")


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_project_plain_is_the_reference_einsum(dtype, cross):
    """``attention._project`` on plain tensors (no mesh: the branch for a
    sequence-split DTensor is not taken) against the reference's
    ``einsum("bsd,dhk->bshk")`` q, k, v, for self- and cross-attention (k,
    v from encoder states): bit for bit in bf16 (both round one f32
    product), within the module's f32 tolerance in f32 (XLA's and torch's
    f32 products sum d in other orders)."""
    from repro_torch.models import attention as A

    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x, enc = (rng.standard_normal(sh).astype(np.float32)
              for sh in ((2, 7, 32), (2, 9, 32)))
    w = {n: rng.standard_normal((32, h, 8)).astype(np.float32)
         for n, h in (("wq", 4), ("wk", 2), ("wv", 2))}
    assert not any(T.split_on(T_(a), 1) for a in (x, enc))
    src = enc if cross else x
    got = A._project({n: T_(v) for n, v in w.items()}, T_(x, td),
                     src=T_(enc, td) if cross else None)
    for t, (inp, name) in zip(got, ((x, "wq"), (src, "wk"), (src, "wv"))):
        want = jnp.einsum("bsd,dhk->bshk", J(inp, jd), J(w[name]).astype(jd))
        assert t.dtype == td
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "bfloat16":
            assert torch.equal(t, T_(want, td))
        else:
            close(t, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_train_logits_match_reference(name, dtype):
    """The four dense configs at ``.smoke()``; seq 96 is past gemma3's
    smoke window (64), so its local layers mask."""
    rc = dataclasses.replace(rconfigs.get_config(name).smoke(), dtype=dtype)
    tc = dataclasses.replace(configs.get_config(name).smoke(), dtype=dtype)
    rp, tp = reference_params(rc, tc)
    toks = np.random.default_rng(5).integers(0, rc.vocab, (2, 96),
                                             dtype=np.int32)
    want, _ = jax.jit(lambda p, t: r_train_logits(rc, p, {"tokens": t}))(
        rp, J(toks))
    got, aux = train_logits(tc, tp, {"tokens": T_(toks)})
    assert got.dtype == DTYPES[dtype][1] and float(aux) == 0.0
    close(got, want.astype(jnp.float32), dtype)


def test_train_logits_at_full_width_layers():
    """gemma3-1b's full-width layers (d 1152, 4 heads, 1 KV head, head_dim
    256, ff 6912, GeGLU, bf16 compute over f32 parameters, remat on) with
    2 layers and vocab 512, seq 64."""
    rc = dataclasses.replace(rconfigs.get_config("gemma3-1b"), n_layers=2,
                             vocab=512)
    tc = dataclasses.replace(configs.get_config("gemma3-1b"), n_layers=2,
                             vocab=512)
    assert tc.remat and tc.dtype == "bfloat16"
    rp, tp = reference_params(rc, tc)
    toks = np.random.default_rng(6).integers(0, 512, (1, 64), dtype=np.int32)
    want, _ = jax.jit(lambda p, t: r_train_logits(rc, p, {"tokens": t}))(
        rp, J(toks))
    got, _ = train_logits(tc, tp, {"tokens": T_(toks)})
    close(got, want.astype(jnp.float32), "bfloat16")


@pytest.mark.parametrize("name", DENSE)
def test_abstract_params_match_reference(name):
    """Leaf names in the reference's flatten order, shapes and dtypes, at
    full size, with nothing allocated (the "meta" device)."""
    got = flatten_named(abstract_params(configs.get_config(name)))
    want = r_abstract_params(rconfigs.get_config(name))
    want = [(jax.tree_util.keystr(path, simple=True, separator="/"), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name_, t), (_, w) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape), name_
        assert str(t.dtype).split(".")[-1] == str(w.dtype), name_


def test_chip_smoke_model_tree_is_the_port_abstract_params():
    """chip_smoke.py's gemma3-1b tree comes from ``abstract_params``; the
    leaf order and shapes are the reference's (999,812,736 f32 elements)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    tree = smoke.model_tree()
    assert list(tree.items()) == [          # the wire buffer's leaf order
        ("embed", (262144, 1152)),
        ("final_norm", (1152,)),
        ("layers/attn/wk", (26, 1152, 1, 256)),
        ("layers/attn/wo", (26, 4, 256, 1152)),
        ("layers/attn/wq", (26, 1152, 4, 256)),
        ("layers/attn/wv", (26, 1152, 1, 256)),
        ("layers/ln1", (26, 1152)),
        ("layers/ln2", (26, 1152)),
        ("layers/mlp/wi", (26, 1152, 2, 6912)),
        ("layers/mlp/wo", (26, 6912, 1152)),
    ]
    assert smoke.leaf_order() == list(tree)
    assert smoke.wire_elements() == 999_812_736


def test_init_params_shapes_and_statistics():
    cfg = configs.get_config("gemma-2b").smoke()
    p = init_params(cfg, 3, "cpu")
    shapes = {n: (tuple(t.shape), t.dtype)
              for n, t in flatten_named(abstract_params(cfg))}
    assert {n: (tuple(t.shape), t.dtype) for n, t in flatten_named(p)} == shapes
    assert float(p["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert not p["layers"]["ln1"].any() and not p["final_norm"].any()
    q = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(p["layers"]["mlp"]["wi"], q["layers"]["mlp"]["wi"])


@pytest.mark.parametrize("name,count", [("mamba2-370m", 368_363_008),
                                        ("zamba2-1.2b", 1_104_937_856),
                                        ("whisper-tiny", 41_197_824)])
def test_ssm_hybrid_encdec_abstract_params_match_reference(name, count):
    """The ssm, hybrid and encdec trees at full size on "meta": the
    reference's leaf names in its flatten order (the hybrid's ``groups``
    nested (G, g, ...), its 2-layer ``tail``, the ``shared`` block; the
    encoder and decoder stacks), shapes and dtypes, and its parameter
    count."""
    got = flatten_named(abstract_params(configs.get_config(name)))
    want = r_abstract_params(rconfigs.get_config(name))
    want = [(jax.tree_util.keystr(path, simple=True, separator="/"), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(want)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name_, t), (_, w) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(w.shape), name_
        assert str(t.dtype).split(".")[-1] == str(w.dtype), name_
    assert sum(t.numel() for _, t in got) == count


def test_mamba2_init_draws_the_reference_ranges():
    """The SSM leaves' draws: exp(A_log) in [1, 16), D one, softplus of
    dt_bias in [1e-3, 1e-1), zero conv bias and norm."""
    p = init_params(configs.get_config("zamba2-1.2b").smoke(), 4, "cpu")
    m = p["groups"]["mamba"]
    assert tuple(m["A_log"].shape) == (2, 6, 16)
    A = torch.exp(m["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) < 1e-1 * (1 + 1e-5)
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    assert not m["conv_b"].any() and not m["norm"].any()
    assert float(m["conv_w"].std()) == pytest.approx(0.1, rel=0.05)


def test_params_from_reference_checks_the_tree():
    cfg = configs.get_config("gemma-2b").smoke()
    tree = jax.tree_util.tree_map(
        np.asarray, r_init_params(rconfigs.get_config("gemma-2b").smoke(),
                                  jax.random.key(1)))
    bad = dict(tree, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, bad, "cpu")
    with pytest.raises(ValueError, match="leaves"):
        params_from_reference(cfg, {k: v for k, v in tree.items()
                                    if k != "embed"}, "cpu")


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("pattern", ["random", "arith"])
@pytest.mark.parametrize("name", ["gemma3-1b", "internvl2-26b",
                                  "whisper-tiny"])
def test_synthetic_lm_batches_are_byte_equal(name, pattern):
    """Tokens for both patterns, and the vlm/encdec stub inputs."""
    for seed in (0, 7):
        r = RSyntheticLM(rconfigs.get_config(name).smoke(), 32, 4, seed=seed,
                         pattern=pattern)
        t = SyntheticLM(configs.get_config(name).smoke(), 32, 4, seed=seed,
                        pattern=pattern)
        for step in (0, 1, 99):
            want, got = r.batch_at(step), t.batch_at(step)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes()
