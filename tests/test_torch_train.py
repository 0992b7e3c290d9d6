"""The port's training path (``repro_torch.train.train_step``,
``repro_torch.launch.train`` and the ``rns_gradient_training`` example)
against the reference's.

Both packages start from the reference's ``init_params`` (carried over with
``params_from_reference``) and take the same ``SyntheticLM`` batches.  The
reference's codec runs as its own tests run it (``make_rns_dp_step`` under
``shard_map`` on the one CPU device, ``tests/test_training_e2e.py``); the
port's runs on a one-rank gloo group, where its wrappers take the codec
kernels' plain versions.

Tolerances, by what is compared:

* loss, ce and gradients at the same parameters (f32 compute): rtol 1e-5,
  and for each gradient leaf an atol of 1e-5 times its largest magnitude.
  The libraries sum in other orders.
* losses over 3 steps: rtol 1e-5; gnorm rtol 1e-5 on the plain path and
  1e-4 on the codec path (see the next item).
* parameters after 3 steps: every element within twice the summed
  learning rates, and at most one element in 1,000 farther apart than
  1e-5.  AdamW divides each gradient by its own running RMS, so an element
  whose gradient is near zero moves by up to the learning rate a step
  whatever its size; a gradient that differs by an ulp can move it the
  other way, and on the codec path a value one ulp from a rounding
  boundary of the 2**-16 quantization can decode one step apart.
* the port against itself: ``--rns-correct`` with an injected fault
  against the same run without one, and the kernel codec against the f64
  codec, give parameters equal bit for bit; ``microbatches=2`` against 1
  agrees to rtol 1e-6 (the two halves' gradients sum in f32 in another
  order).
* two gloo ranks, each on half the batch, against one rank on the whole
  batch: the reference's own ``rtol=2e-2, atol=2e-2`` on the losses.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.configs import get_config as r_get_config
from repro.dist.grad_codec import GradCodec as RCodec
from repro.launch.train import make_rns_dp_step as r_make_rns_dp_step
from repro.models import init_params as r_init_params
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import adamw_init as r_adamw_init
from repro.train.train_step import make_loss_fn as r_make_loss_fn
from repro.train.train_step import make_train_step as r_make_train_step
from repro_torch import rns_gradient_training
from repro_torch.configs import get_config
from repro_torch.dist._tree import flatten_named
from repro_torch.dist.grad_codec import GradCodec
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import make_rns_dp_step
from repro_torch.models import params_from_reference
from repro_torch.train import AdamWConfig, SyntheticLM, adamw_init
from repro_torch.train.train_step import (
    make_loss_fn,
    make_train_step,
    value_and_grad,
)

ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup=2, decay_steps=10, weight_decay=0.0)
STEPS = 3


def named(tree):
    """{"a/b": numpy leaf} of a reference tree (jax) or a port tree."""
    if isinstance(tree, dict) and any(isinstance(l, torch.Tensor)
                                      for _, l in flatten_named(tree)):
        return {n: l.detach().numpy() for n, l in flatten_named(tree)}
    return {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(l)
            for p, l in jax.tree_util.tree_leaves_with_path(tree)}


def start(name):
    """(reference cfg, port cfg, reference params, port params, loader)."""
    rc, tc = r_get_config(name).smoke(), get_config(name).smoke()
    rp = r_init_params(rc, jax.random.key(0))
    tp = params_from_reference(tc, jax.tree_util.tree_map(np.asarray, rp),
                               "cpu")
    return rc, tc, rp, tp, SyntheticLM(tc, seq=80, batch=4, pattern="arith")


def batch_at(loader, step):
    b = loader.batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def lr_sum(steps):
    """The learning rates of the first ``steps`` AdamW steps, summed."""
    from repro_torch.train.optimizer import _schedule

    cfg = AdamWConfig(**OPT)
    return sum(float(_schedule(cfg, torch.tensor(s))) for s in
               range(1, steps + 1))


def params_close(got, want, steps=STEPS):
    got, want = named(got), named(want)
    assert list(got) == list(want)
    for n in want:
        d = np.abs(got[n] - want[n])
        assert d.max() <= 2 * lr_sum(steps), (n, d.max())
        assert (d > 1e-5).sum() <= d.size // 1000, (n, (d > 1e-5).sum())


@pytest.fixture(scope="module")
def gloo1():
    """A one-rank gloo process group over an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# ---------------------------------------------------------- loss and grads
@pytest.mark.parametrize("name", ["gemma3-1b", "llama3.2-3b"])
def test_loss_and_gradients_match_value_and_grad(name):
    """Against ``jax.value_and_grad(make_loss_fn(cfg))``, leaf by leaf, in
    f32 compute; seq 80 is past gemma3's smoke window (64)."""
    rc, tc, rp, tp, loader = start(name)
    rb, tb = batch_at(loader, 0)
    (rl, (rce, raux)), rg = jax.jit(
        jax.value_and_grad(r_make_loss_fn(rc), has_aux=True))(rp, rb)
    loss, ce, aux, grads = value_and_grad(make_loss_fn(tc), tp, tb)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(rce), rtol=1e-5)
    assert float(aux) == float(raux) == 0.0
    got, want = named(grads), named(rg)
    assert list(got) == list(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[n]).max(),
                                   err_msg=n)
    # the parameters come back untouched: no grad state survives the call
    assert not any(p.requires_grad for _, p in flatten_named(tp))


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("path", ["plain", "codec"])
@pytest.mark.parametrize("name", ["gemma3-1b", "llama3.2-3b"])
def test_train_steps_match_reference(gloo1, name, path):
    """3 steps of ``make_train_step`` (plain) or of ``make_rns_dp_step``
    over ``GradCodec.make(world=2)`` (codec), from the same parameters and
    batches."""
    rc, tc, rp, tp, loader = start(name)
    if path == "plain":
        r_fn = jax.jit(r_make_train_step(rc, RAdamWConfig(**OPT)))
        t_fn = make_train_step(tc, AdamWConfig(**OPT))
    else:
        r_fn, _ = r_make_rns_dp_step(rc, RAdamWConfig(**OPT),
                                     RCodec.make(world=2))
        t_fn, world = make_rns_dp_step(tc, AdamWConfig(**OPT),
                                       GradCodec.make(world=2))
        assert world == 1
    r_opt, t_opt = r_adamw_init(rp), adamw_init(tp)
    for step in range(STEPS):
        rb, tb = batch_at(loader, step)
        rp, r_opt, rm = r_fn(rp, r_opt, rb)
        tp, t_opt, tm = t_fn(tp, t_opt, tb)
        assert sorted(tm) == sorted(rm)
        for k in ("loss", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["gnorm"]), float(rm["gnorm"]),
                                   rtol=1e-5 if path == "plain" else 1e-4)
        assert int(tm["opt_step"]) == int(rm["opt_step"]) == step + 1
    params_close(tp, rp)
    for k in ("m", "v"):
        assert list(named(t_opt[k])) == list(named(r_opt[k]))


def test_microbatches_equal_one_batch():
    _, tc, _, tp, loader = start("gemma-2b")
    opt = AdamWConfig(**OPT)
    _, tb = batch_at(loader, 0)
    one = make_train_step(tc, opt)(tp, adamw_init(tp), tb)
    two = make_train_step(tc, opt, microbatches=2)(tp, adamw_init(tp), tb)
    for k in ("loss", "ce", "gnorm"):
        np.testing.assert_allclose(float(two[2][k]), float(one[2][k]),
                                   rtol=1e-6)
    params_close(two[0], one[0], steps=1)
    with pytest.raises(ValueError, match="3 equal microbatches"):
        make_train_step(tc, opt, microbatches=3)(tp, adamw_init(tp), tb)


def test_the_codec_step_writes_its_new_state_into_the_dead_wire(gloo1):
    """Without a transport hook the codec step's new parameters and moments
    are views of the decoded wire's one block; with an identity hook (which
    could keep the wire) they are fresh tensors.  The two runs are equal
    bit for bit, and the state passed in is never written to."""
    _, tc, _, tp, loader = start("gemma-2b")
    opt, codec = AdamWConfig(**OPT), GradCodec.make(world=2)
    into_wire = make_train_step(tc, opt, rns_codec=codec, group=gloo1)
    fresh = make_train_step(tc, opt, rns_codec=codec, group=gloo1,
                            transport_hook=lambda buf: buf)
    st0 = adamw_init(tp)
    p0, m0 = named(tp), named(st0["m"])
    a = b = (tp, st0)
    for step in range(2):
        _, tb = batch_at(loader, step)
        a, b = into_wire(*a[:2], tb), fresh(*b[:2], tb)
        blocks = lambda *trees: [l.untyped_storage().data_ptr()
                                 for t in trees for _, l in flatten_named(t)]
        assert len(set(blocks(a[0], a[1]["m"], a[1]["v"]))) == 1
        assert len(set(blocks(b[0]))) == len(blocks(b[0]))
        for k in ("loss", "gnorm"):
            assert float(a[2][k]) == float(b[2][k])
    for got, want in ((a[0], b[0]), (a[1]["m"], b[1]["m"]),
                      (a[1]["v"], b[1]["v"])):
        got, want = named(got), named(want)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    for got, want in ((tp, p0), (st0["m"], m0)):
        for n, leaf in named(got).items():
            np.testing.assert_array_equal(leaf, want[n], err_msg=n)


def test_repair_needs_a_correct_codec():
    with pytest.raises(ValueError, match="locate-and-correct"):
        make_train_step(get_config("gemma-2b").smoke(), AdamWConfig(),
                        rns_codec=GradCodec.make(world=2), rns_repair=True)


# ----------------------------------------------------------------- driver
def cli(*args):
    return ["--device", "cpu", "--arch", "gemma-2b", "--batch", "2",
            "--seq", "16", *args]


def run_main(*args):
    params, summary = launch_train.main(cli(*args))
    return named(params), summary


def test_rns_correct_repairs_an_injected_fault_bitwise():
    """One residue of the wire buffer corrupted at step 1 is located and
    repaired before the all-reduce: the parameters are those of the run
    without the fault, bit for bit."""
    clean, s0 = run_main("--steps", "3", "--rns-correct")
    hit, s1 = run_main("--steps", "3", "--rns-correct",
                       "--inject-corrupt-step", "1")
    assert s0["repaired"] == [0, 0, 0] and s1["repaired"] == [0, 1, 0]
    assert s0["unrepairable"] == s1["unrepairable"] == [0, 0, 0]
    assert s1["losses"] == s0["losses"]
    for n in clean:
        np.testing.assert_array_equal(hit[n], clean[n], err_msg=n)


def test_kernel_codec_equals_f64_codec_bitwise():
    fused, _ = run_main("--steps", "2", "--rns-allreduce")
    f64, summary = run_main("--steps", "2", "--rns-allreduce",
                            "--unfused-codec")
    assert summary["rns"] and summary["world"] == 1
    for n in fused:
        np.testing.assert_array_equal(f64[n], fused[n], err_msg=n)


def test_inject_needs_rns_correct():
    with pytest.raises(SystemExit):
        launch_train.main(cli("--steps", "1", "--inject-corrupt-step", "0"))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def summary_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_two_gloo_ranks_match_one_rank_on_the_whole_batch():
    """Two processes with torchrun's environment: each takes half of every
    batch, the gradients meet in one int32 all-reduce, and the losses agree
    with one rank stepping on the whole batch."""
    args = [sys.executable, "-m", "repro_torch.launch.train",
            *cli("--steps", "3", "--rns-allreduce")]
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(rank),
                   LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(args, env=env, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    two = [summary_line(o) for o in outs]
    assert two[0]["world"] == two[1]["world"] == 2
    assert two[0]["losses"] == two[1]["losses"]
    _, one = run_main("--steps", "3", "--rns-allreduce")
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=2e-2,
                               atol=2e-2)


def test_cli_prints_its_summary_line():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *cli("--steps", "3", "--rns-allreduce")],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("[rns] RNS gradient all-reduce over 1 rank")
    assert [ln.split()[:2] for ln in lines[1:4]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    s = summary_line(out.stdout)
    assert s["arch"] == "gemma-2b-smoke" and s["device"] == "cpu"
    assert len(s["losses"]) == len(s["step_ms"]) == len(s["tokens_per_s"]) == 3
    assert all(np.isfinite(s["losses"])) and s["max_memory_allocated"] is None


def test_rns_gradient_training_example():
    """The port of examples/rns_gradient_training.py on the CPU: loss drift
    against fp32 under 0.05 over 45 steps, and the RNS run learns."""
    out = rns_gradient_training.main("cpu", verbose=False)
    assert out["drift"] < rns_gradient_training.MAX_DRIFT
    assert len(out["l_rns"]) == len(out["l_fp"]) == rns_gradient_training.STEPS
    assert out["l_rns"][-1] < out["l_rns"][0] - 1.0


def test_cli_profiler_window(tmp_path, capsys):
    """``--profile-*`` (the reference's
    ``test_train_driver_profiler_window``): steps 1 and 2 captured into
    one non-empty Chrome trace under ``profile_train``."""
    from repro_torch.launch.train import main as train_main

    train_main(cli("--steps", "4", "--profile-start-step", "1",
                   "--profile-steps", "2", "--profile-dir", str(tmp_path)))
    out = capsys.readouterr().out
    assert f"[profile] captured 2 step(s) under {tmp_path}/profile_train" \
        in out
    traces = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
              for f in fs]
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


def test_cli_checkpoint_lines_and_summary(tmp_path, capsys):
    """``--ckpt-dir``: the reference's ``[ckpt]`` line, one async save a
    ``--save-every`` steps in the summary's ``ckpt_saves``; resumed, the
    ``[resume]`` line and ``start_step``, the summary still the last
    line."""
    from repro_torch.launch.train import main as train_main

    ck = str(tmp_path / "ck")
    _, first = train_main(cli("--steps", "4", "--save-every", "2",
                              "--ckpt-dir", ck))
    out = capsys.readouterr().out
    assert f"[ckpt] policy '2', keep all, async RRNS-coded saves under " \
        f"{ck}" in out
    assert [s["step"] for s in first["ckpt_saves"]] == [2, 4]
    assert all(s["bytes"] > 0 and s["snapshot_ms"] >= 0
               for s in first["ckpt_saves"])
    _, second = train_main(cli("--steps", "5", "--ckpt-dir", ck,
                               "--ckpt-policy", "1", "--ckpt-keep", "2"))
    out = capsys.readouterr().out
    assert "[resume] restored step 4:" in out
    assert "[ckpt] policy '1', keep 2," in out
    assert out.strip().splitlines()[-1] == json.dumps(second)
    assert second["start_step"] == 4 and len(second["losses"]) == 1
    assert sorted(os.listdir(ck)) == ["step_4", "step_5"]
