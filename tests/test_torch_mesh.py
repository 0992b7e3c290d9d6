"""Training and restore on a device mesh over four gloo CPU ranks.

The ranks run once for the module (subprocesses over a FileStore, as
``test_torch_codec.py``'s two-rank transport test), with a 2-layer
gemma3-1b smoke model (ZeRO-1 on), and report what each case needs:

  * two fp32 steps on a (data 2, model 2) mesh against the same steps in
    one process: the parameters within ``FP32_ATOL`` (tensor parallelism
    sums row-parallel partial products in another order, so not bit for
    bit);
  * the codec step on (2, 2): each rank's summed wire bit for bit the sum
    of the local wires of its data group (an integer sum, exact in any
    order), and on (4, 1) bit for bit the sum of the wires one process
    encodes from the four quarter-batch gradients;
  * a ZeRO-1 state saved from (2, 2) by both checkpoint modules and
    restored onto (4, 1) with ``shardings=``: equal values, the new mesh's
    placements;
  * ``dist.sharding.local_slices`` against DTensor's own cut of uneven and
    nested shards;
  * ``flash_attention``'s three routes with q's heads split over "model"
    against the same calls in one process.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
FP32_ATOL = 1e-6

CHILD = r'''
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, Replicate, distribute_tensor
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(d + "/store", 4),
                        rank=rank, world_size=4)
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.dist import _tree
from repro_torch.dist import sharding as sh
from repro_torch.dist.grad_codec import GradCodec, tree_pack_rns
from repro_torch.train import checkpoint, checkpointer
from repro_torch.train import train_step as TS
from repro_torch.train.optimizer import AdamWConfig, adamw_init

cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=2,
                          zero1=True)
p0 = init_params(cfg, 0, "cpu")
tok = torch.from_numpy(np.random.default_rng(0).integers(
    0, cfg.vocab, (4, 17)).astype(np.int32))
out = {}

def place(tree, specs, mesh):
    return _tree.tree_map(sh.place_host, tree, sh.named_shardings(specs, mesh))

def setup(mesh):
    ps = sh.param_specs(p0, mesh)
    zs = sh.opt_state_specs(p0, ps, mesh, zero1=cfg.zero1)
    st = adamw_init(p0)
    opt = {"m": place(st["m"], zs, mesh), "v": place(st["v"], zs, mesh),
           "step": st["step"]}
    batch = place({"tokens": tok}, sh.batch_specs({"tokens": tok}, mesh), mesh)
    return place(p0, ps, mesh), opt, batch, sh.named_shardings(ps, mesh), zs

full = lambda tree: _tree.tree_map(
    lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)

# -- fp32 on (2, 2) against one process
m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
params, opt, batch, psh, zs22 = setup(m22)
step = TS.make_train_step(cfg, AdamWConfig(), grad_shardings=psh, mesh=m22)
for _ in range(2):
    params, opt, met = step(params, opt, batch)
got = full(params)
ref = TS.make_train_step(cfg, AdamWConfig())
pr, sr = p0, adamw_init(p0)
for _ in range(2):
    pr, sr, mr = ref(pr, sr, {"tokens": tok})
out["fp32_max_err"] = max(float((a - b).abs().max()) for a, b in
                          zip(_tree.flatten(got)[0], _tree.flatten(pr)[0]))
out["fp32_loss"] = [float(met["loss"]), float(mr["loss"])]
out["zero1_m_placements"] = str(opt["m"]["embed"].placements)
saved = {"params": got, "opt": {"m": full(opt["m"]), "v": full(opt["v"]),
                                "step": opt["step"]}}

# -- the codec's wire on (2, 2) and (4, 1)
wires = {}
orig_psum = TS.psum
def capture(t, g):
    wires.setdefault("local", t.clone())
    s = orig_psum(t, g)
    wires.setdefault("summed", s.clone())
    return s
TS.psum = capture
codec = GradCodec.make(world=2)
params, opt, batch, psh, _ = setup(m22)
TS.make_train_step(cfg, AdamWConfig(), grad_shardings=psh, mesh=m22,
                   rns_codec=codec)(params, opt, batch)
group = m22.get_group("data")
parts = [torch.empty_like(wires["local"]) for _ in range(2)]
dist.all_gather(parts, wires["local"], group=group)
ok22 = torch.equal(parts[0] + parts[1], wires["summed"])

m41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
wires.clear()
codec4 = GradCodec.make(world=4)
params, opt, batch, psh, zs41 = setup(m41)
TS.make_train_step(cfg, AdamWConfig(), grad_shardings=psh, mesh=m41,
                   rns_codec=codec4)(params, opt, batch)
TS.psum = orig_psum
lf = TS.make_loss_fn(cfg)
total = None
for r in range(4):
    g = TS.value_and_grad(lf, p0, {"tokens": tok[r:r + 1]})[3]
    w = tree_pack_rns(codec4, g)[0].residues
    total = w.clone() if total is None else total + w
ok41 = torch.equal(total, wires["summed"])
flags = torch.tensor([int(ok22), int(ok41)])
dist.all_reduce(flags, op=dist.ReduceOp.MIN)
out["codec_22_sum_of_local_wires"] = bool(flags[0])
out["codec_41_equals_one_process"] = bool(flags[1])

# -- ZeRO-1 state saved from (2, 2), restored onto (4, 1)
if rank == 0:
    checkpoint.save(d + "/legacy", 2, saved)
    checkpointer.write_step_dir(d + "/rrns", 2, saved)
dist.barrier()
ps41 = sh.param_specs(p0, m41)
shard41 = {"params": sh.named_shardings(ps41, m41),
           "opt": {"m": sh.named_shardings(zs41, m41),
                   "v": sh.named_shardings(zs41, m41),
                   "step": sh.named_shardings(sh.PartitionSpec(), m41)}}
for name, fn in (("legacy", checkpoint.restore),
                 ("rrns", checkpointer.restore)):
    res = fn(d + "/" + name, saved, shard41)
    tree, st = res[0], res[1]
    equal = all(torch.equal(a.full_tensor(), b) for a, b in
                zip(_tree.flatten(tree)[0], _tree.flatten(saved)[0]))
    placed = all(a.placements == s.placements for a, s in
                 zip(_tree.flatten(tree)[0], _tree.flatten(shard41)[0]))
    local = tree["opt"]["m"]["embed"].to_local().shape
    out["restore_" + name] = [st, equal, placed, list(local)]

# -- local_slices against DTensor's own cut
t = torch.arange(5 * 7, dtype=torch.float32).reshape(5, 7)
cuts = []
for pl in ((Shard(0), Shard(1)), (Shard(0), Shard(0)), (Shard(1), Shard(1)),
           (Replicate(), Shard(0))):
    want = distribute_tensor(t, m22, pl).to_local()
    cuts.append(torch.equal(want, t[sh.local_slices((5, 7), m22, pl)]))
out["local_slices"] = cuts
# -- flash_attention's routes with the heads split over "model"
from repro_torch.dist.act_sharding import use_mesh
from repro_torch.models.attention import IMPLS, flash_attention
rng = np.random.default_rng(1)
flash = {}
for g in (2, 1):
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 128, n, 16)).astype(np.float32)) for n in (4, g, g, 4))
    kv_pl = (Shard(0), Shard(2) if g == 2 else Replicate())
    for impl in IMPLS:
        for causal, window in ((True, None), (True, 40), (False, None)):
            kw = dict(causal=causal, window=window, q_chunk=32, kv_chunk=32,
                      impl=impl)
            grad = impl != "scan"
            one = [t.clone().requires_grad_(grad) for t in (q, k, v)]
            want = flash_attention(*one, **kw)
            placed = [distribute_tensor(t, m22, pl).detach()
                      .requires_grad_(grad) for t, pl in
                      ((q, (Shard(0), Shard(2))), (k, kv_pl), (v, kv_pl))]
            with use_mesh(m22):
                got = flash_attention(*placed, **kw)
            def rel(a, b):      # the largest error over the largest |b|
                return float((a - b).abs().max() / b.abs().max())
            errs = [rel(got.full_tensor(), want)]
            if grad:
                want.backward(do)
                (got * distribute_tensor(do, m22, got.placements)
                 ).sum().backward()
                errs += [rel(a.grad.full_tensor(), b.grad)
                         for a, b in zip(placed, one)]
            flash[f"g{g}/{impl}/{causal}/{window}"] = [
                str(got.placements), errs]
out["flash"] = flash
json.dump(out, open(f"{d}/out{rank}.json", "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(d)],
                              env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [json.loads((d / f"out{r}.json").read_text())
            for r in range(WORLD)]


def test_fp32_steps_on_2x2_match_one_process(ranks):
    for out in ranks:
        assert out["fp32_max_err"] <= FP32_ATOL, out["fp32_max_err"]
        a, b = out["fp32_loss"]
        assert abs(a - b) <= 1e-5 * abs(b)
    # ZeRO-1: the moments shard over "data" beside the parameter's own
    # "model" placement
    assert ranks[0]["zero1_m_placements"] == "(Shard(dim=1), Shard(dim=0))"


def test_codec_wire_sums_exactly(ranks):
    for out in ranks:
        assert out["codec_22_sum_of_local_wires"]
        assert out["codec_41_equals_one_process"]


@pytest.mark.parametrize("module", ["legacy", "rrns"])
def test_zero1_state_restores_onto_another_mesh(ranks, module):
    """Saved from (2, 2) with the moments sharded over 2 data ranks,
    restored onto (4, 1): the same values, the (4, 1) placements, and a
    local moment shard a quarter of the embed's rows."""
    for out in ranks:
        step, equal, placed, local = out["restore_" + module]
        assert step == 2 and equal and placed
        assert local == [128, 128]    # embed (512, 128): vocab over 4


def test_flash_routes_on_2x2_match_no_mesh(ranks):
    """Each route of ``flash_attention``, causal with and without a window
    and not causal, on (data 2, model 2) with q's heads split two ways
    (and for g = 1 the KV heads repeated to follow them): the output placed
    as q, and it and, for vjp and unrolled, dq, dk, dv as one process
    computes them, within ``test_torch_models.py``'s f32 tolerance: 1e-5
    (2e-5 for gradients) of the largest magnitude.  The shards' matmuls
    sum in other orders than the whole batch's."""
    for out in ranks:
        assert len(out["flash"]) == 2 * 3 * 3
        for case, (placements, errs) in out["flash"].items():
            assert placements == "(Shard(dim=0), Shard(dim=2))", case
            assert errs[0] <= 1e-5, (case, errs)
            assert all(e <= 2e-5 for e in errs[1:]), (case, errs)


def test_local_slices_match_dtensor(ranks):
    for out in ranks:
        assert all(out["local_slices"])
