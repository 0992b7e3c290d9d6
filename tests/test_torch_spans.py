"""The port's spans (``repro_torch.spans``) in its training step, on the
CPU under ``torch.profiler``: which ranges a step records, how many and
inside which, and that with no profiler the step is the same step.

The model is a tiny mamba2 (2 layers, d_model 64, chunk 8, seq 32) with
remat on, in f32.  A range is a ``user_annotation`` event of the Chrome
trace; on the CPU the backward runs on the caller's thread, so the twins'
ranges nest in time with the forward's.
"""
import dataclasses
import json

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.dist._tree import flatten_named
from repro_torch.dist.grad_codec import GradCodec
from repro_torch.kernels import rrns_repair
from repro_torch.launch.train import _corrupt_wire
from repro_torch.models import init_params
from repro_torch.models.ssm_models import ssm_prefill
from repro_torch.train import AdamWConfig, adamw_init
from repro_torch.train import train_step as ts

CFG = dataclasses.replace(get_config("mamba2-370m").smoke(), n_layers=2,
                          d_model=64, ssm_chunk=8, remat=True)
BATCH, SEQ = 2, 32
OPT = AdamWConfig(lr=1e-3, warmup=2, decay_steps=10)
MODEL = {"train.step", "train.forward", "train.backward", "train.ce",
         "train.ce.bwd", "model.unembed", "model.unembed.bwd", "ssm.mixer",
         "ssm.mixer.bwd", "ssm.conv", "ssm.conv.bwd", "ssm.ssd",
         "ssm.ssd.bwd", "remat.recompute", "optim.adamw"}
CODEC = {"codec.pack", "codec.repair", "codec.wire", "codec.decode"}
RRNS = {"rrns.scan"}
NODES = {"_OpenBackward", "_CloseBackward"}


@pytest.fixture(scope="module")
def gloo1():
    """A one-rank gloo process group over an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def batch(seed=1):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, CFG.vocab, (BATCH, SEQ + 1),
                                    generator=g, dtype=torch.int32)}


def run_step(step, profiled, tmp_path=None):
    """One step from seed-0 parameters: (params, metrics, the ranges of
    the step's Chrome trace as (name, start, end), or None)."""
    params = init_params(CFG, 0, "cpu")
    opt_state = adamw_init(params)
    if not profiled:
        return (*step(params, opt_state, batch())[::2], None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        params, _, metrics = step(params, opt_state, batch())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return params, metrics, ranges


def names(ranges, name):
    return [r for r in ranges if r[0] == name]


def inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def graph_nodes(fn):
    """``fn()`` with ``torch.autograd.grad`` watched: the type names of
    the nodes of every graph it differentiates."""
    seen, orig = set(), torch.autograd.grad

    def grad(outputs, *a, **kw):
        todo, done = [outputs.grad_fn], set()
        while todo:
            node = todo.pop()
            if node is not None and node not in done:
                done.add(node)
                seen.add(type(node).__name__)
                todo += [n for n, _ in node.next_functions]
        return orig(outputs, *a, **kw)

    torch.autograd.grad = grad
    try:
        fn()
    finally:
        torch.autograd.grad = orig
    return seen


def test_off_path_adds_no_node_and_changes_no_bit(tmp_path):
    """With no profiler a step's graph holds no node of the spans' (under
    one it does), and its parameters and metrics equal bit for bit those
    of the same step under a CPU profiler."""
    step = ts.make_train_step(CFG, OPT)
    off = graph_nodes(lambda: run_step(step, False))
    assert off and not off & NODES
    with profile(activities=[ProfilerActivity.CPU]):
        assert NODES <= graph_nodes(lambda: run_step(step, False))
    p0, m0, _ = run_step(step, False)
    p1, m1, _ = run_step(step, True, tmp_path)
    for (k, x), (_, y) in zip(flatten_named(p0), flatten_named(p1)):
        assert torch.equal(x, y), k
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k


def test_profiled_step_has_the_model_and_step_spans(tmp_path):
    """Every model and step span, once a layer where it is a layer's
    (the SSD and its twin, the recompute), and each where it runs: the
    SSD inside the mixer inside the forward, every twin and every
    recompute inside the backward, and no span opened in a recompute."""
    _, _, ranges = run_step(ts.make_train_step(CFG, OPT), True, tmp_path)
    assert MODEL <= {r[0] for r in ranges}
    assert not (CODEC | RRNS) & {r[0] for r in ranges}
    L = CFG.n_layers
    for name in ("ssm.ssd", "ssm.ssd.bwd", "ssm.conv", "ssm.conv.bwd",
                 "ssm.mixer", "ssm.mixer.bwd", "remat.recompute"):
        assert len(names(ranges, name)) == L, name
    for name in ("train.step", "train.forward", "train.backward",
                 "train.ce", "train.ce.bwd", "model.unembed",
                 "model.unembed.bwd", "optim.adamw"):
        assert len(names(ranges, name)) == 1, name
    (fwd,), (bwd,) = names(ranges, "train.forward"), names(
        ranges, "train.backward")
    mixers = names(ranges, "ssm.mixer")
    for r in names(ranges, "ssm.ssd") + names(ranges, "ssm.conv"):
        assert any(inside(r, m) for m in mixers), r
    for r in mixers + names(ranges, "model.unembed") + names(ranges,
                                                             "train.ce"):
        assert inside(r, fwd), r
    for r in ranges:
        if r[0].endswith(".bwd") or r[0] == "remat.recompute":
            assert inside(r, bwd), r
    assert fwd[2] <= bwd[1]
    for rec in names(ranges, "remat.recompute"):
        assert not [r for r in ranges if r[0].startswith("ssm.")
                    and not r[0].endswith(".bwd") and inside(r, rec)]
    (step,) = names(ranges, "train.step")
    assert all(inside(r, step) for r in ranges if r is not step)


def test_profiled_codec_step_has_the_codec_and_rrns_spans(gloo1, tmp_path,
                                                          monkeypatch):
    """A codec step with the RRNS repair and one injected wire fault: every
    ``codec.*`` span and one ``rrns.scan``, the repair's one call over the
    wire (the plain version cuts it into three passes here, none of them a
    span), inside ``codec.repair``; the decode inside ``optim.adamw``."""
    codec = GradCodec.make(world=2, correct=True)
    n = sum(p.numel() for _, p in flatten_named(init_params(CFG, 0, "cpu")))
    monkeypatch.setattr(rrns_repair, "REPAIR_COLUMNS", -(-n // 3))
    step = ts.make_train_step(CFG, OPT, rns_codec=codec, group=gloo1,
                              rns_repair=True,
                              transport_hook=_corrupt_wire(codec))
    _, metrics, ranges = run_step(step, True, tmp_path)
    assert int(metrics["repaired"]) == 1 and int(metrics["unrepairable"]) == 0
    assert MODEL | CODEC | RRNS <= {r[0] for r in ranges}
    assert not [r for r in ranges if r[0].startswith("rrns.")
                and r[0] not in RRNS]
    assert len(names(ranges, "rrns.scan")) == 1
    (rep,), (adam,) = names(ranges, "codec.repair"), names(ranges,
                                                           "optim.adamw")
    assert all(inside(r, rep) for r in ranges if r[0].startswith("rrns."))
    assert all(inside(r, adam) for r in names(ranges, "codec.decode"))


def test_spans_without_gradients_get_no_twin(tmp_path):
    """Prefill under ``inference_mode`` (the serving path) records the
    model's spans and no backward twin."""
    params = init_params(CFG, 0, "cpu")
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU]) as prof:
        ssm_prefill(CFG, params, {"tokens": batch()["tokens"][:, :SEQ]},
                    SEQ)
    got = [e.name for e in prof.events()]
    for name in ("ssm.mixer", "ssm.conv", "ssm.ssd"):
        assert got.count(name) == CFG.n_layers, name
    assert got.count("model.unembed") == 1
    assert not [n for n in got if n.endswith(".bwd")]


def test_traced_call_outside_a_profiler_is_the_function():
    """``traced`` returns the function's own result objects with no
    profiler, and ``span`` is one shared no-op context."""
    x = torch.ones(3, requires_grad=True)
    f = spans.traced("t")(lambda a, b: (a * 2, b))
    y, b = f(x, "b")
    assert b == "b" and y.grad_fn.name() == "MulBackward0"
    assert spans.span("a") is spans.span("b")
