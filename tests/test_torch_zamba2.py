"""Zamba2's published hybrid layout in the port (``ssm_models`` with
``hybrid_layer_ids``, ``ssm.ssd`` with B/C groups) against the benchmark's
plain reference, ``portbench/reference/zamba2.py``, and that reference
against the published code, transformers' ``Zamba2Model``.

The port runs on the CPU at a small size of the published layout: two
B/C groups, two shared blocks over four hybrid layers, so that each block
is used twice with different adapters, on seeded random weights whose norm
scales, conv biases and skips are drawn away from their initial values.

Tolerances, by what is compared:

* the port and the reference in f32: the same products in other orders
  (the SSD's chunked sums, the chunked online softmax against a whole-row
  one, the MLP's two products against one): logits and each gradient leaf
  within rtol 1e-5 plus 1e-5 of the largest magnitude, the loss within
  rtol 1e-5 (``test_torch_ssm.py``'s f32 bound; 2e-7 of the largest
  magnitude seen);
* remat on against off, and one B/C group given with or without its axis:
  the same operations on the same values, so equal bit for bit;
* G groups against G one-group calls on each group's heads: the same
  products batched otherwise, rtol 1e-6 plus 1e-6 of the largest;
* the reference against transformers in f32: RoPE's inverse frequencies
  formed two ways in f32 and other summation orders, within 1e-5 of the
  largest magnitude (3e-8 seen); the grouped mixer against the plain
  recurrence in float64, within 1e-10;
* the chunked attention at hd 224 against a whole-row softmax in f32:
  rtol 1e-5 plus 1e-5 of the largest magnitude, forward and gradients.

transformers' plain-torch Zamba2 mixer (the path it takes without the
CUDA kernels) sums the chunk-to-chunk states over the wrong axis, which
changes every chunk's state after the first; the published model runs
the CUDA kernels.  So the cross-check runs one chunk a row, and the
reference's chunked SSD is held against the recurrence instead.
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.dist._tree import flatten_named
from repro_torch.models import init_params, prefill, train_logits
from repro_torch.models import attention as TA
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.train.train_step import make_loss_fn, value_and_grad

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import model as blocks  # noqa: E402
from portbench.reference import zamba2 as ref  # noqa: E402

SMALL = ModelConfig(
    name="zamba2-small", family="hybrid", n_layers=7, d_model=32, n_heads=4,
    n_kv=4, head_dim=16, d_ff=64, vocab=128, act="geglu_exact",
    norm_eps=1e-5, ssm_state=8, ssm_headdim=8, ssm_chunk=8, ssm_groups=2,
    hybrid_layer_ids=(1, 2, 4, 6), n_mem_blocks=2, adapter_rank=4,
    dtype="float32", remat=False).validate()
BATCH, SEQ = 2, 32


def close(got, want, rtol=1e-5):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale)


def small_params(cfg=SMALL, seed=0):
    """The port's parameters with the zero- and one-initialised leaves
    (norm scales, conv biases, D) drawn away from their initial values."""
    params = init_params(cfg, seed, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name, t in flatten_named(params):
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("ln", "ln1", "ln2", "norm", "final_norm", "conv_b", "D"):
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    return params


def tokens(cfg=SMALL, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (BATCH, SEQ + 1), generator=g)


def model_dict(cfg):
    return dataclasses.asdict(cfg)


def leaf_grads(loss, params):
    names = [n for n, _ in flatten_named(params)]
    leaves = [t for _, t in flatten_named(params)]
    return dict(zip(names, torch.autograd.grad(loss, leaves)))


def reference_loss_and_grads(cfg, params, toks):
    ref_params = {k: v for k, v in params.items()}
    named = dict(flatten_named(ref_params))
    for t in named.values():
        t.requires_grad_()
    loss = blocks.loss_of_rows(ref.logits, ref_params, model_dict(cfg), toks)
    grads = leaf_grads(loss, ref_params)
    for t in named.values():
        t.requires_grad_(False)
    return loss.detach(), grads


# ------------------------------------------------- the port, the reference
def test_logits_match_the_reference():
    params = small_params()
    x = tokens()[:, :-1]
    got, aux = train_logits(SMALL, params, {"tokens": x})
    want = ref.logits(params, model_dict(SMALL), x.long(), blocks._mm)
    close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_the_reference(remat):
    """Every leaf, the shared blocks' (summed over their two uses each)
    and each hybrid layer's adapter and linear included."""
    cfg = dataclasses.replace(SMALL, remat=remat)
    params = small_params()
    toks = tokens()
    loss, _, _, grads = value_and_grad(make_loss_fn(cfg), params,
                                       {"tokens": toks})
    want_loss, want = reference_loss_and_grads(cfg, params, toks)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    got = dict(flatten_named(grads))
    assert sorted(got) == sorted(want)
    for name in want:
        close(got[name], want[name])
    # both blocks and all four adapters take part
    assert all(float(got[n].abs().amax(dim=tuple(range(1, got[n].ndim)))
                     .min()) > 0 for n in ("blocks/mlp/wi", "blocks/attn/wq",
                                           "hybrid/adapter_a",
                                           "hybrid/linear"))


def test_remat_on_and_off_are_equal():
    params = small_params()
    batch = {"tokens": tokens()}
    outs = []
    for remat in (False, True):
        cfg = dataclasses.replace(SMALL, remat=remat)
        outs.append(value_and_grad(make_loss_fn(cfg), params, batch))
    (l0, _, _, g0), (l1, _, _, g1) = outs
    assert torch.equal(l0, l1)
    for (n, a), (_, b) in zip(flatten_named(g0), flatten_named(g1)):
        assert torch.equal(a, b), n


def test_the_benchmark_layout_is_the_ports():
    """The benchmark's parameter layout (``families/hybrid.py``) names and
    shapes the leaves as the port's tree has them, at the cell's size."""
    import json

    from portbench.families import hybrid

    m = json.loads((ROOT / "portbench" / "configs" /
                    "zamba2_7b.json").read_text())["model"]
    cfg = ModelConfig(**m).validate()
    port = {n: tuple(t.shape) for n, t in flatten_named(
        init_params(cfg, 0, "meta"))}
    spec = {"/".join(p): tuple(s) for p, s, _ in hybrid.param_spec(m)}
    assert port == spec
    assert sum(math.prod(s) for s in spec.values()) == 1_757_853_120


# --------------------------------------------------------- groups of B, C
def ssd_inputs(G, dtype=torch.float32, seed=5):
    g = torch.Generator().manual_seed(seed)
    b, s, h, p, n = 2, 32, 4, 3, 5
    x = torch.randn(b, s, h, p, generator=g, dtype=dtype)
    dt = torch.rand(b, s, h, generator=g, dtype=dtype) * 0.5
    A = -torch.rand(h, generator=g, dtype=dtype) - 0.5
    B = torch.randn(b, s, G, n, generator=g, dtype=dtype)
    C = torch.randn(b, s, G, n, generator=g, dtype=dtype)
    S0 = torch.randn(b, h, n, p, generator=g, dtype=dtype)
    return x, dt, A, B, C, S0


def ssd_and_grads(x, dt, A, B, C, S0):
    ins = [t.detach().requires_grad_() for t in (x, dt, A, B, C, S0)]
    y, S_last = S.ssd(*ins[:5], 8, ins[5])
    grads = torch.autograd.grad((y * y).sum() + (S_last * S_last).sum(),
                                ins)
    return y.detach(), S_last.detach(), grads


def test_one_group_with_or_without_its_axis_is_bit_equal():
    x, dt, A, B, C, S0 = ssd_inputs(1)
    with_axis = ssd_and_grads(x, dt, A, B, C, S0)
    without = ssd_and_grads(x, dt, A, B[:, :, 0], C[:, :, 0], S0)
    assert torch.equal(with_axis[0], without[0])
    assert torch.equal(with_axis[1], without[1])
    for a, b in zip(with_axis[2], without[2]):
        assert torch.equal(a.reshape(b.shape), b)


def test_groups_are_one_group_calls_on_their_heads():
    x, dt, A, B, C, S0 = ssd_inputs(2)
    y, S_last, _ = ssd_and_grads(x, dt, A, B, C, S0)
    for g, hs in enumerate((slice(0, 2), slice(2, 4))):
        yg, Sg, _ = ssd_and_grads(x[:, :, hs], dt[:, :, hs], A[hs],
                                  B[:, :, g], C[:, :, g], S0[:, hs])
        close(y[:, :, hs], yg, rtol=1e-6)
        close(S_last[:, hs], Sg, rtol=1e-6)


def test_grouped_decode_continues_the_grouped_prefix():
    """A Mamba2 layer of two groups: decoding from a prefix's state gives
    the whole forward's outputs, one token at a time."""
    cfg = dataclasses.replace(SMALL, family="ssm", hybrid_layer_ids=(),
                              n_mem_blocks=0, adapter_rank=0)
    g = torch.Generator().manual_seed(7)
    P = S.init_mamba2(g, cfg, torch.float32, "cpu")
    P["norm"].add_(0.1 * torch.randn(P["norm"].shape, generator=g))
    u = torch.randn(2, 16, cfg.d_model, generator=g)
    whole, _ = S.mamba2_forward(P, cfg, u)
    head, st = S.mamba2_forward(P, cfg, u[:, :8])
    close(head, whole[:, :8])
    for t in range(8, 16):
        out, st = S.mamba2_decode(P, cfg, u[:, t:t + 1], st)
        close(out, whole[:, t:t + 1])


def test_the_references_grouped_mixer_is_the_recurrence():
    m = dict(model_dict(SMALL), ssm_chunk=8)
    g = torch.Generator().manual_seed(11)
    P = {k: v.double() for k, v in S.init_mamba2(
        g, SMALL, torch.float32, "cpu").items()}
    P["norm"] = P["norm"] + 0.1 * torch.randn(P["norm"].shape, generator=g,
                                              dtype=torch.float64)
    u = torch.randn(2, 32, SMALL.d_model, generator=g, dtype=torch.float64)
    d_in, h, p, n, G = SMALL.d_inner, SMALL.ssm_heads, 8, 8, 2
    z, xBC, dt = torch.split(u @ P["in_proj"], [d_in, d_in + 2 * G * n, h],
                             dim=-1)
    x, B, C = torch.split(blocks._conv_silu(xBC, P["conv_w"], P["conv_b"]),
                          [d_in, G * n, G * n], dim=-1)
    x = x.reshape(2, 32, h, p)
    dt = torch.nn.functional.softplus(dt + P["dt_bias"])
    A = -torch.exp(P["A_log"])
    B = B.reshape(2, 32, G, n).repeat_interleave(h // G, dim=2)
    C = C.reshape(2, 32, G, n).repeat_interleave(h // G, dim=2)
    state, ys = torch.zeros(2, h, n, p, dtype=torch.float64), []
    for t in range(32):
        state = (torch.exp(dt[:, t] * A)[..., None, None] * state
                 + (dt[:, t, :, None, None] * B[:, t, :, :, None]
                    * x[:, t, :, None, :]))
        ys.append(torch.einsum("bhn,bhnp->bhp", C[:, t], state))
    y = (torch.stack(ys, dim=1) + P["D"][:, None] * x).reshape(2, 32, d_in)
    y = blocks.rms_norm((y * torch.nn.functional.silu(z)).reshape(
        2, 32, G, -1), P["norm"].reshape(G, -1), SMALL.norm_eps)
    want = y.reshape(2, 32, d_in) @ P["out_proj"]
    torch.testing.assert_close(ref.mamba2_grouped(P, m, u, blocks._mm), want,
                               rtol=1e-10, atol=1e-10)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("impl", ["vjp", "unrolled"])
def test_chunked_attention_at_hd_224_and_a_given_scale(impl):
    """Training's routes at Zamba2's head size and softmax scale, over
    four query chunks, against a whole-row softmax: the output and the
    gradients of q, k and v (the vjp route's hand-written backward)."""
    g = torch.Generator().manual_seed(2)
    b, s, h, hd = 1, 64, 2, 224
    scale = (hd / 2) ** -0.5
    q, k, v = (torch.randn(b, s, h, hd, generator=g) for _ in range(3))
    dout = torch.randn(b, s, h, hd, generator=g)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return (out.detach(), *torch.autograd.grad(out, ins, dout))

    def whole(q, k, v):
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        hidden = torch.ones(s, s, dtype=torch.bool).triu(1)
        p = torch.softmax(scores.masked_fill(hidden, -math.inf), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    got = run(lambda q, k, v: TA.flash_attention(
        q, k, v, q_chunk=16, kv_chunk=16, impl=impl, scale=scale))
    for a, w in zip(got, run(whole)):
        close(a, w)


def test_default_scale_is_unchanged():
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 32, 4, 16, generator=g) for _ in range(3))
    a = TA.flash_attention(q, k, v, q_chunk=8, kv_chunk=8)
    b = TA.flash_attention(q, k, v, q_chunk=8, kv_chunk=8, scale=16 ** -0.5)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ spans
def test_profiled_step_has_the_shared_block_spans(tmp_path):
    """A remat training step under a CPU profiler: ``hybrid.shared`` and
    ``hybrid.attn`` once a hybrid layer in the forward, the attention
    inside its block, each with its ``.bwd`` twin inside the backward, and
    none opened in a recompute; the grouped SSD under ``ssm.ssd``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(SMALL, remat=True)
    step = make_train_step(cfg, AdamWConfig(warmup=2, decay_steps=10))
    params = small_params(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, adamw_init(params), {"tokens": tokens()})
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def named(name):
        return [r for r in ranges if r[0] == name]

    def inside(r, outer):
        return outer[1] <= r[1] and r[2] <= outer[2]

    H = len(cfg.hybrid_layer_ids)
    for name in ("hybrid.shared", "hybrid.shared.bwd", "hybrid.attn",
                 "hybrid.attn.bwd"):
        assert len(named(name)) == H, name
    assert len(named("ssm.ssd")) == cfg.n_layers
    (fwd,), (bwd,) = named("train.forward"), named("train.backward")
    for r in named("hybrid.attn"):
        assert inside(r, fwd) and any(inside(r, b)
                                      for b in named("hybrid.shared"))
    for r in named("hybrid.shared.bwd") + named("hybrid.attn.bwd"):
        assert inside(r, bwd)
    for rec in named("remat.recompute"):
        assert not [r for r in ranges if r[0].startswith("hybrid.")
                    and not r[0].endswith(".bwd") and inside(r, rec)]


# ------------------------------------------------------ config and serving
def test_the_published_config():
    cfg = get_config("zamba2_7b")
    assert "zamba2_7b" not in ARCHS
    assert cfg.published_hybrid and cfg.n_layers == 81
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                    65, 71, 77)
    assert (cfg.ssm_heads, cfg.ssm_groups, cfg.n_heads * cfg.head_dim) == (
        112, 2, 2 * cfg.d_model)
    smoke = cfg.smoke().validate()
    assert smoke.hybrid_layer_ids == (6, 11) and smoke.n_layers == 12
    params = init_params(smoke, 0, "cpu")
    logits, _ = train_logits(smoke, params,
                             {"tokens": torch.zeros(1, 16, dtype=torch.long)})
    assert logits.shape == (1, 16, smoke.vocab)


@pytest.mark.parametrize("bad", [
    {"ssm_groups": 3},                        # 8 heads in 3 groups
    {"hybrid_layer_ids": (1, 7)},             # past the last layer
    {"hybrid_layer_ids": (4, 2)},             # not in order
    {"head_dim": 8},                          # attention not 2 d wide
    {"n_mem_blocks": 0},
    {"adapter_rank": 0},
    {"act": "gelu"},
])
def test_validate_refuses(bad):
    with pytest.raises(AssertionError):
        dataclasses.replace(SMALL, **bad).validate()


def test_serving_the_published_layout_is_refused():
    with pytest.raises(NotImplementedError, match="published Zamba2"):
        prefill(SMALL, small_params(), {"tokens": tokens()[:, :8]}, 16)


# ------------------------------------------- the reference, the published
def _hf_model(monkeypatch):
    monkeypatch.setenv("USE_TF", "0")
    tf = pytest.importorskip("transformers")
    from transformers.models.zamba2.modeling_zamba2 import Zamba2Model

    d, types = 32, ["mamba", "hybrid", "mamba", "hybrid"]
    cfg = tf.Zamba2Config(
        vocab_size=64, hidden_size=d, num_hidden_layers=4,
        layers_block_type=types, mamba_d_state=8, mamba_d_conv=4,
        mamba_expand=2, mamba_ngroups=2, n_mamba_heads=8, chunk_size=SEQ,
        intermediate_size=64, num_attention_heads=4, num_mem_blocks=2,
        adapter_rank=4, use_mem_rope=True, rms_norm_eps=1e-5,
        attn_implementation="eager", max_position_embeddings=SEQ)
    torch.manual_seed(0)
    hf = Zamba2Model(cfg).float().eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("norm.weight"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            elif name.endswith("conv1d.bias") or name.endswith(".D"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    for mod in hf.modules():   # the published CUDA path clamps no dt
        if hasattr(mod, "time_step_min"):
            mod.time_step_min = 0.0
    return cfg, hf


def _from_hf(cfg, hf):
    """The reference's parameters of a transformers Zamba2Model: products
    transposed to (in, out), norm scales as w - 1."""
    d, H, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.attention_head_dim
    ff = cfg.intermediate_size

    def T(w):
        return w.detach().T.contiguous()

    def mamba(layer):
        mx = layer.mamba
        return {"ln": layer.input_layernorm.weight.detach() - 1,
                "mamba": {"in_proj": T(mx.in_proj.weight),
                          "conv_w": T(mx.conv1d.weight[:, 0, :]),
                          "conv_b": mx.conv1d.bias.detach(),
                          "A_log": mx.A_log.detach(), "D": mx.D.detach(),
                          "dt_bias": mx.dt_bias.detach(),
                          "norm": mx.norm.weight.detach() - 1,
                          "out_proj": T(mx.out_proj.weight)}}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    layers, hyb, blks = [], [], {}
    for layer in hf.layers:
        if not hasattr(layer, "shared_transformer"):
            layers.append(mamba(layer))
            continue
        k, st = len(hyb), layer.shared_transformer
        ad, at = st.feed_forward.gate_up_proj_adapter_list[k], st.self_attn
        hyb.append({"adapter_a": T(ad[0].weight), "adapter_b": T(ad[1].weight),
                    "linear": T(layer.linear.weight)})
        blks[st.block_id] = {
            "ln1": st.input_layernorm.weight.detach() - 1,
            "attn": {"wq": T(at.q_proj.weight).reshape(2 * d, H, hd),
                     "wk": T(at.k_proj.weight).reshape(2 * d, H, hd),
                     "wv": T(at.v_proj.weight).reshape(2 * d, H, hd),
                     "wo": T(at.o_proj.weight).reshape(H, hd, d)},
            "ln2": st.pre_ff_layernorm.weight.detach() - 1,
            "mlp": {"wi": T(st.feed_forward.gate_up_proj.weight).reshape(
                d, 2, ff), "wo": T(st.feed_forward.down_proj.weight)}}
        layers.append(mamba(layer.mamba_decoder))
    m = {"d_model": d, "n_layers": cfg.num_hidden_layers, "n_heads": H,
         "n_kv": cfg.num_key_value_heads, "head_dim": hd,
         "ssm_expand": cfg.mamba_expand, "ssm_headdim": cfg.mamba_headdim,
         "ssm_state": cfg.mamba_d_state, "ssm_groups": cfg.mamba_ngroups,
         "ssm_chunk": cfg.chunk_size, "norm_eps": cfg.rms_norm_eps,
         "rope_theta": float(cfg.rope_theta),
         "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
         "n_mem_blocks": cfg.num_mem_blocks}
    return m, {"layers": stack(layers), "hybrid": stack(hyb),
               "blocks": stack([blks[i] for i in range(len(blks))])}


def test_the_reference_is_the_published_hybrid_layer(monkeypatch):
    cfg, hf = _hf_model(monkeypatch)
    m, params = _from_hf(cfg, hf)
    g = torch.Generator().manual_seed(2)
    x, e = (torch.randn(BATCH, SEQ, cfg.hidden_size, generator=g)
            for _ in range(2))
    pos = torch.arange(SEQ)
    with torch.no_grad():
        want = hf.layers[1](
            x, original_hidden_states=e, layer_idx=1,
            causal_mask=hf._update_causal_mask(None, x, pos),
            position_embeddings=hf.rotary_emb(x, pos[None]))[0]
        got = ref.hybrid_layer(blocks.layer(params["blocks"], (0,)),
                               blocks.layer(params["hybrid"], (0,)),
                               blocks.layer(params["layers"], (1,)), m, x, e,
                               blocks._mm)
    close(got, want)


def test_the_reference_is_the_published_stack(monkeypatch):
    """Two Mamba2 layers and two hybrid layers, one on each shared block,
    from the embedding's output (the port's sqrt(d) factor stays out) to
    the final norm."""
    cfg, hf = _hf_model(monkeypatch)
    m, params = _from_hf(cfg, hf)
    e = torch.randn(BATCH, SEQ, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = hf(inputs_embeds=e).last_hidden_state
        got = blocks.rms_norm(ref.stack(params, m, e, blocks._mm),
                              hf.final_layernorm.weight - 1, m["norm_eps"])
    close(got, want)
