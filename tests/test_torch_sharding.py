"""The sharding layer of the port (``repro_torch.dist.sharding``,
``dist.act_sharding``, ``launch.mesh``, ``launch.dryrun``) against the
reference's, on the CPU.

The spec trees must equal the reference's entry for entry for every
registry config at full width (abstract shapes: ``meta`` tensors against
``jax.eval_shape``), on stand-in meshes of the reference's own kind
(``_FakeMesh``: the spec functions read only axis names and sizes).
``logical_to_physical`` must agree over a grid of names, shapes and
meshes, its ``None`` results and ``ValueError``s included.  On a (1, 1)
mesh over a one-rank gloo group, training (two fp32 and two codec steps)
and the batched and paged engines must be bit for bit what they are with
no mesh.  The dry run runs one cell on a small fake mesh in a subprocess.
Multi-rank runs are in ``test_torch_mesh.py`` and
``test_torch_mesh_serve.py``.
"""
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.configs import ALIASES
from repro.configs import get_config as r_get_config
from repro.dist import act_sharding as r_act
from repro.dist import sharding as r_sh
from repro.models import abstract_params as r_abstract_params
from repro.serve.serve_step import cache_abstract as r_cache_abstract
from repro.serve.serve_step import prompt_abstract as r_prompt_abstract
from repro_torch.configs import get_config
from repro_torch.dist import _tree
from repro_torch.dist import act_sharding as act
from repro_torch.dist import sharding as sh
from repro_torch.models import abstract_params, init_params
from repro_torch.serve.serve_step import (cache_zeros, paged_pool_zeros,
                                          prompt_zeros)

ROOT = Path(__file__).resolve().parents[1]


class _FakeMesh:
    """The reference's stand-in (``tests/test_dist.py``): the spec functions
    only read ``.shape`` and ``.axis_names``."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "4x8": dict(data=4, model=8),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
    "1x1": dict(data=1, model=1),
}


def r_specs(tree):
    return [tuple(s) for s in
            jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, RP))]


def t_specs(tree):
    leaves = _tree.flatten(tree)[0]
    assert all(isinstance(s, sh.PartitionSpec) for s in leaves)
    return [tuple(s) for s in leaves]


def r_names(tree):
    return ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def t_names(tree):
    return [n for n, _ in _tree.flatten_named(tree)]


# ------------------------------------------------------------ spec trees
@pytest.mark.parametrize("arch", list(ALIASES))
def test_param_and_opt_specs_match_reference(arch):
    rc, tc = r_get_config(arch), get_config(arch)
    ra, ta = r_abstract_params(rc), abstract_params(tc)
    assert r_names(ra) == t_names(ta)
    for name, shape in MESHES.items():
        mesh = _FakeMesh(**shape)
        rp = r_sh.param_specs(ra, mesh, n_experts=rc.n_experts)
        tp = sh.param_specs(ta, mesh, n_experts=tc.n_experts)
        assert r_specs(rp) == t_specs(tp), (arch, name)
        for zero1 in (True, False):
            assert (r_specs(r_sh.opt_state_specs(ra, rp, mesh, zero1=zero1))
                    == t_specs(sh.opt_state_specs(ta, tp, mesh,
                                                  zero1=zero1))), \
                (arch, name, zero1)


@pytest.mark.parametrize("arch", list(ALIASES))
def test_batch_specs_match_reference(arch):
    """The training batch (tokens and the family's stub inputs) and a
    prompt batch, at global batches that do and do not divide the data
    axes."""
    rc, tc = r_get_config(arch), get_config(arch)
    for batch, name in itertools.product((256, 32, 2, 1), MESHES):
        mesh = _FakeMesh(**MESHES[name])
        rb = r_prompt_abstract(rc, batch, 64)
        rb["tokens"] = jax.ShapeDtypeStruct((batch, 65), jnp.int32)
        tb = prompt_zeros(tc, batch, 64, "meta")
        tb["tokens"] = torch.empty((batch, 65), dtype=torch.int32,
                                   device="meta")
        assert (r_specs(r_sh.batch_specs(rb, mesh))
                == t_specs(sh.batch_specs(tb, mesh))), (arch, batch, name)
    scalar = jax.ShapeDtypeStruct((), jnp.int32)
    assert (tuple(r_sh.batch_specs(scalar, _FakeMesh(data=4, model=8)))
            == tuple(sh.batch_specs(torch.empty((), device="meta"),
                                    _FakeMesh(data=4, model=8))) == ())


@pytest.mark.parametrize("arch", list(ALIASES))
def test_cache_specs_match_reference(arch):
    """The decode cache (the reference's ``cache_abstract``, an eval_shape
    of its prefill) and, for the paged families, the page pool, with
    ``paged_pool`` on and off."""
    rc, tc = r_get_config(arch), get_config(arch)
    ra = r_abstract_params(rc)
    cases = [(r_cache_abstract(rc, ra, 32, 1024),
              cache_zeros(tc, 32, 1024, "meta"))]
    if tc.family in ("dense", "moe"):   # the pool holds linear rows
        rl = dataclasses.replace(rc, window_cache=False)
        tl = dataclasses.replace(tc, window_cache=False)
        cases.append((r_cache_abstract(rl, ra, 48, 16),
                      paged_pool_zeros(tl, 48, 16, "meta")))
    for (rca, tca), name, paged in itertools.product(cases, MESHES,
                                                     (False, True)):
        mesh = _FakeMesh(**MESHES[name])
        assert r_names(rca) == t_names(tca)
        assert (r_specs(r_sh.cache_specs(rca, mesh, paged_pool=paged))
                == t_specs(sh.cache_specs(tca, mesh, paged_pool=paged))), \
            (arch, name, paged)


def test_specs_shard_what_divides():
    """The reference's own spot checks (``tests/test_dist.py``) on the
    port: gemma-2b on (data 4, model 8)."""
    cfg = get_config("gemma-2b")
    pa = abstract_params(cfg)
    mesh = _FakeMesh(data=4, model=8)
    s = sh.param_specs(pa, mesh)
    assert s["embed"] == ("model", None)
    assert s["layers"]["attn"]["wq"] == (None, None, "model", None)
    assert s["layers"]["attn"]["wk"] == (None, None, None, None)
    assert s["layers"]["mlp"]["wo"] == (None, "model", None)
    z = sh.opt_state_specs(pa, s, mesh, zero1=True)
    assert z["embed"] == ("model", "data")
    assert z["layers"]["ln1"] == (None, "data")


# ------------------------------------------------------- logical axes
NAMES = [None, "batch", "heads", "kv", "ff", "vocab", "seq", "dinner",
         "experts", "embed", "model", "?seq", "?batch_plus", "?heads",
         "?bogus", "bogus"]
SHAPES = [(8, 16, 4), (2, 3, 7), (256, 4096, 1), (1, 32, 16), (16, 1, 6)]


def _resolve(mod, mesh, names, shape):
    try:
        out = mod.logical_to_physical(mesh, names, shape)
    except ValueError as e:
        return ("ValueError", str(e))
    return None if out is None else tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["model_only",
                                                      "data_only"])
def test_logical_to_physical_matches_reference(mesh_name):
    shape = {"model_only": dict(model=4), "data_only": dict(data=8)}.get(
        mesh_name) or MESHES[mesh_name]
    mesh = _FakeMesh(**shape)
    seen = {"none": 0, "error": 0, "spec": 0}
    for names in itertools.product(NAMES, repeat=3):
        for s in SHAPES:
            want = _resolve(r_act, mesh, names, s)
            got = _resolve(act, mesh, names, s)
            assert got == want, (mesh_name, names, s)
            seen["none" if want is None else "error"
                 if want and want[0] == "ValueError" else "spec"] += 1
    with pytest.raises(ValueError, match="names for rank"):
        act.logical_to_physical(mesh, ("batch",), (2, 2))
    assert seen["error"] and (seen["none"] or mesh_name == "data_only")


def test_constrain_is_identity_off_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert act.current_mesh() is None
    assert act.constrain(x, "batch", "ff") is x
    with act.use_mesh(None):
        assert act.constrain(x, "batch", "ff") is x


def test_use_mesh_nests_and_restores():
    mesh, inner = _FakeMesh(data=2, model=2), _FakeMesh(data=1, model=4)
    with act.use_mesh(mesh) as m:
        assert m is mesh and act.current_mesh() is mesh
        with act.use_mesh(None):
            assert act.current_mesh() is None
        with act.use_mesh(inner):
            assert act.current_mesh() is inner
        assert act.current_mesh() is mesh
        # a plain tensor on a mesh passes through
        x = torch.ones(4, 4)
        assert act.constrain(x, "batch", "ff") is x
    assert act.current_mesh() is None


def test_use_mesh_keeps_implicit_replication_while_any_is_open():
    """``implicit_replication()`` clears its process-wide flag on exit;
    ``use_mesh`` blocks share one entry, so an inner block's exit (or a
    recompute's on another thread) leaves the outer one replicating."""
    from torch.distributed.tensor import DTensor

    flag = lambda: DTensor._op_dispatcher._allow_implicit_replication
    mesh = _FakeMesh(data=1, model=1)
    with act.use_mesh(mesh):
        with act.use_mesh(mesh):
            assert flag()
        assert flag()
    assert not flag()


def test_remat_recompute_sees_the_forward_mesh():
    """The backward may run a checkpointed layer's recompute on another
    thread (the autograd engine's device threads), where the forward's
    context is not: ``layers.remat`` re-enters the forward's mesh."""
    import threading

    from repro_torch.models.layers import remat

    seen = []

    def layer(x):
        seen.append(act.current_mesh())
        return (x * 2.0).sin()

    mesh = _FakeMesh(data=2, model=2)
    x = torch.ones(3, requires_grad=True)
    with act.use_mesh(mesh):
        y = remat(layer, x).sum()
    grads = []
    t = threading.Thread(target=lambda: grads.append(
        torch.autograd.grad(y, x)[0]))
    t.start()
    t.join()
    assert seen == [mesh, mesh]           # the forward, then the recompute
    assert torch.equal(grads[0], 2.0 * (x.detach() * 2.0).cos())
    seen.clear()
    remat(layer, torch.ones(2, requires_grad=True)).sum().backward()
    assert seen == [None, None]


def test_named_shardings_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh(pod=2, data=4, model=8)
    spec = sh.PartitionSpec(("pod", "data"), None, "model")
    ns = sh.named_shardings({"a": spec, "b": sh.PartitionSpec()}, mesh)
    assert ns["a"].placements == (Shard(0), Shard(0), Shard(2))
    assert ns["b"].placements == (Replicate(),) * 3
    assert ns["a"].spec == spec
    with pytest.raises(ValueError, match="major-to-minor"):
        sh.named_shardings(sh.PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="named twice"):
        sh.named_shardings(sh.PartitionSpec("model", "model"), mesh)


# ----------------------------------------------- a (1, 1) mesh on the CPU
@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh

    made = not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def _cfg():
    return dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=2,
                               zero1=True)


def _placed(tree, specs, mesh):
    ns = sh.named_shardings(specs, mesh)
    return _tree.tree_map(sh.place_host, tree, ns)


def test_host_mesh_shape_and_device(host_mesh):
    assert host_mesh.mesh_dim_names == ("data", "model")
    assert tuple(host_mesh.shape) == (1, 1)
    assert sh.mesh_device(host_mesh) == torch.device("cpu")
    assert sh.mesh_axes(host_mesh) == {"data": 1, "model": 1}


def test_host_mesh_training_is_bitwise_no_mesh(host_mesh):
    """Two fp32 and two codec steps of a 2-layer gemma3-1b smoke model on
    the (1, 1) mesh: parameters, moments and metrics bit for bit those of
    the same steps without a mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = _cfg()
    p0 = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))}
        for _ in range(4)]
    ps = sh.param_specs(p0, host_mesh)
    zs = sh.opt_state_specs(p0, ps, host_mesh, zero1=cfg.zero1)
    grad_sh = sh.named_shardings(ps, host_mesh)
    codec = GradCodec.make(world=1)
    plain = {"params": p0, "opt": adamw_init(p0)}
    st = adamw_init(p0)
    mesh_state = {"params": _placed(p0, ps, host_mesh),
                  "opt": {"m": _placed(st["m"], zs, host_mesh),
                          "v": _placed(st["v"], zs, host_mesh),
                          "step": st["step"]}}
    opt_cfg = AdamWConfig(warmup=1)
    for i, b in enumerate(batches):
        kw = {"rns_codec": codec} if i >= 2 else {}
        p, o, m = make_train_step(cfg, opt_cfg, group=(dist.group.WORLD
                                                       if kw else None),
                                  **kw)(plain["params"], plain["opt"], b)
        plain = {"params": p, "opt": o}
        bm = _placed(b, sh.batch_specs(b, host_mesh), host_mesh)
        p2, o2, m2 = make_train_step(cfg, opt_cfg, mesh=host_mesh,
                                     grad_shardings=grad_sh, **kw)(
            mesh_state["params"], mesh_state["opt"], bm)
        mesh_state = {"params": p2, "opt": o2}
        for k in ("loss", "ce", "gnorm"):
            assert not isinstance(m2[k], DTensor)
            assert torch.equal(m[k], m2[k]), (i, k)
        for (name, a), (_, d) in zip(_tree.flatten_named(plain),
                                     _tree.flatten_named(mesh_state)):
            if isinstance(d, DTensor):
                d = d.full_tensor()
            assert torch.equal(a, d), (i, name)
    got = mesh_state["params"]["layers"]["mlp"]["wi"]
    assert got.placements == grad_sh["layers"]["mlp"]["wi"].placements


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-26b"])
def test_host_mesh_step_of_other_families_is_bitwise_no_mesh(host_mesh,
                                                            arch):
    """The moe block (its weights gathered, run per batch shard under
    ``local_map``) and the vlm family's patch prefix: one fp32 step on the
    (1, 1) mesh, parameters and loss bit for bit those of no mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_config(arch).smoke(), n_layers=2)
    p0 = init_params(cfg, 0, "cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_patches, cfg.d_model)).astype(np.float32))
    p1, _, m1 = make_train_step(cfg, AdamWConfig())(p0, adamw_init(p0), batch)
    ps = sh.param_specs(p0, host_mesh, n_experts=cfg.n_experts)
    zs = sh.opt_state_specs(p0, ps, host_mesh)
    st = adamw_init(p0)
    opt = {"m": _placed(st["m"], zs, host_mesh),
           "v": _placed(st["v"], zs, host_mesh), "step": st["step"]}
    p2, _, m2 = make_train_step(
        cfg, AdamWConfig(), mesh=host_mesh,
        grad_shardings=sh.named_shardings(ps, host_mesh))(
        _placed(p0, ps, host_mesh), opt,
        _placed(batch, sh.batch_specs(batch, host_mesh), host_mesh))
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["aux"],
                                                               m2["aux"])
    for (name, a), b in zip(_tree.flatten_named(p1), _tree.flatten(p2)[0]):
        assert isinstance(b, DTensor)
        assert torch.equal(a, b.full_tensor()), name


def test_host_mesh_engines_are_bitwise_no_mesh(host_mesh):
    """The batched and the paged engine with ``mesh=`` on the (1, 1) mesh:
    tokens, fingerprints and every cache leaf bit for bit those of the
    engine without a mesh; the cache is placed (DTensors) and the engine
    refuses DTensor parameters."""
    from torch.distributed.tensor import DTensor

    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.scheduler import Request

    cfg = _cfg()
    params = init_params(cfg, 1, "cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab, n)]
               for n in (9, 17, 12)]

    def run(mesh, **kw):
        eng = ContinuousBatcher(cfg, params, n_slots=2, cache_len=64,
                                prefill_chunk=8, rns_verify=True, mesh=mesh,
                                **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid=rid, prompt=p, max_new=4))
        out = sorted((r.rid, list(r.out)) for r in eng.run_to_completion())
        return out, dict(eng.verify_log), eng

    for kw in ({}, {"page_size": 8}):
        want, wlog, e0 = run(None, **kw)
        got, glog, e1 = run(host_mesh, **kw)
        assert got == want and glog == wlog and all(wlog.values())
        for k, v in e1.cache.items():
            if isinstance(v, torch.Tensor):
                assert isinstance(v, DTensor)
                assert torch.equal(v.full_tensor(), e0.cache[k]), (kw, k)
    with pytest.raises(TypeError, match="whole parameters"):
        ContinuousBatcher(cfg, _placed(params, sh.param_specs(
            params, host_mesh), host_mesh), n_slots=2, cache_len=64,
            prefill_chunk=8, mesh=host_mesh)


def test_kernel_wrappers_refuse_dtensors(host_mesh):
    from repro_torch.dist.grad_codec import GradCodec
    from repro_torch.kernels import build, ops

    g = sh.place_host(torch.ones(4, 3), sh.named_shardings(
        sh.PartitionSpec(None, None), host_mesh))
    with pytest.raises(TypeError, match="local shard"):
        ops._on_card(g)
    with pytest.raises(TypeError, match="local shard"):
        build.pointers("codec_encode", g, dtype=torch.float32)
    codec = GradCodec.make(world=1)
    with pytest.raises(TypeError, match="local shard"):
        codec.encode_packed(g)
    assert codec.encode_packed(g.to_local()).shape == (4, 3, codec.base.n + 1)


def test_saves_refuse_dtensors(host_mesh, tmp_path):
    """A step holds whole leaves: a DTensor is gathered first, and both
    checkpoint modules say so rather than write a shard."""
    from repro_torch.train import checkpoint, checkpointer

    g = sh.place_host(torch.ones(4, 3), sh.named_shardings(
        sh.PartitionSpec(None, None), host_mesh))
    with pytest.raises(TypeError, match="full_tensor"):
        checkpoint.save(str(tmp_path / "a"), 1, {"g": g})
    with pytest.raises(TypeError, match="full_tensor"):
        checkpointer.write_step_dir(str(tmp_path / "b"), 1, {"g": g})
    checkpoint.save(str(tmp_path / "a"), 1, {"g": g.full_tensor()})


def test_local_slices_chunk_like_dtensor(host_mesh):
    """``local_slices`` on a mesh of one: the whole tensor, every
    placement; uneven and nested splits are held against DTensor's own
    cut in ``test_torch_mesh.py``'s four ranks."""
    from torch.distributed.tensor import Replicate, Shard

    for pl in ((Shard(0), Shard(1)), (Shard(1), Shard(1)),
               (Replicate(), Replicate())):
        assert sh.local_slices((5, 7), host_mesh, pl) == (slice(0, 5),
                                                           slice(0, 7))


# --------------------------------------------------------------- dry run
def test_dryrun_small_mesh_subprocess(tmp_path):
    """One cell (gemma3-1b decode_32k) on a (data 4, model 2) mesh over a
    fake group of 8, in a process of its own: the record has the keys it
    promises, and its argument bytes are the spec trees' own sum of local
    shard sizes (each axis cut in ``torch.chunk``'s ceil-sized pieces)."""
    child = (
        "import json, sys\n"
        "from torch.distributed.device_mesh import init_device_mesh\n"
        "from repro_torch.launch import dryrun\n"
        "dryrun.fake_world(8)\n"
        "mesh = init_device_mesh('cpu', (4, 2), "
        "mesh_dim_names=('data', 'model'))\n"
        "rec = dryrun.run_cell('gemma3-1b', 'decode_32k', 'small', "
        "mesh=mesh)\n"
        "json.dump(rec, open(sys.argv[1], 'w'))\n"
    )
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", child, str(out)], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(out.read_text())
    for key in ("arch", "shape", "mesh", "devices", "kind", "seq",
                "global_batch", "memory", "collectives", "roofline",
                "model_flops_global", "model_flops_per_device",
                "useful_flops_ratio", "knobs"):
        assert key in rec, key
    assert rec["devices"] == 8 and rec["kind"] == "decode"
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "per_device_bytes", "fits_hbm"):
        assert key in rec["memory"]
    for key in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "total", "ops"):
        assert key in rec["collectives"]
    assert rec["collectives"]["ops"] > 0 and rec["roofline"]["flops_per_device"] > 0
    from repro_torch.launch.roofline_report import fmt_row

    row = fmt_row(rec).split("|")
    assert row[1:4] == [" gemma3-1b ", " decode_32k ", " small "]
    assert row[-2].strip() in ("Y", "N")

    mesh = _FakeMesh(data=4, model=2)
    cfg = dataclasses.replace(get_config("gemma3-1b"),
                              param_dtype="bfloat16")

    def local_bytes(tree, specs):
        total = 0
        for t, s in zip(_tree.flatten(tree)[0], _tree.flatten(specs)[0]):
            if not isinstance(t, torch.Tensor):
                continue
            shape = list(t.shape)
            for i, e in enumerate(s):
                for a in ((e,) if isinstance(e, str) else (e or ())):
                    shape[i] = -(-shape[i] // mesh.shape[a])
            total += math.prod(shape) * t.element_size()
        return total

    pa = abstract_params(cfg)
    cache = cache_zeros(cfg, 128, 32768, "meta")
    tokens = torch.empty((128, 1), dtype=torch.int32, device="meta")
    want = (local_bytes(pa, sh.param_specs(pa, mesh))
            + local_bytes(cache, sh.cache_specs(cache, mesh))
            + local_bytes(tokens, sh.batch_specs(tokens, mesh)))
    assert rec["memory"]["argument_bytes"] == want
    assert (rec["memory"]["per_device_bytes"]
            == want + rec["memory"]["temp_bytes"])
