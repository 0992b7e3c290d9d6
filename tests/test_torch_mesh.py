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
    against the same calls in one process;
  * ``attention._project`` with its weights split along their heads and
    its input along its sequence, ``ssm._causal_depthwise_conv`` of a split
    sequence, ``attention.decode_attention`` of heads-split queries, a
    Mamba2 block with its SSD heads split and ``layers.gated_mlp`` of a
    split sequence (the branches torch 2.11's DTensor needs) against the
    plain path.
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
# -- the projection with its heads split and the conv of a split sequence
from repro_torch.models import attention as A, ssm as S
def grads_of(fn, *ts):
    ts = [t.detach().requires_grad_(True) for t in ts]
    y = fn(*ts)
    return y, ts
rng = np.random.default_rng(2)
x, enc, do = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              for sh in ((4, 6, 32), (4, 10, 32), (4, 6, 4, 8)))
w = {n: torch.from_numpy(rng.standard_normal((32, h, 8)).astype(np.float32))
     for n, h in (("wq", 4), ("wk", 2), ("wv", 2))}
heads = (Replicate(), Shard(1))
sites = {}
for name, x_pl, src in (("batch", (Shard(0), Replicate()), None),
                        ("sequence", (Shard(0), Shard(1)), None),
                        ("cross", (Shard(0), Shard(1)), enc)):
    want = A._project(w, x, src=src)
    one = [t.clone().requires_grad_(True) for t in (x, w["wq"])]
    A._project({**w, "wq": one[1]}, one[0], src=src)[0].backward(do)
    px = distribute_tensor(x, m22, x_pl).requires_grad_(True)
    pw = {n: distribute_tensor(t, m22, heads).requires_grad_(n == "wq")
          for n, t in w.items()}
    psrc = None if src is None else distribute_tensor(src, m22, x_pl)
    got = A._project(pw, px, src=psrc)
    (got[0] * distribute_tensor(do, m22, got[0].placements)).sum().backward()
    sites["project/" + name] = [
        [str(g.placements) for g in got],
        all(torch.equal(g.full_tensor(), t) for g, t in zip(got, want)),
        [float((a.grad.full_tensor() - b.grad).abs().max()
               / b.grad.abs().max()) for a, b in ((px, one[0]),
                                                  (pw["wq"], one[1]))]]
xc, wc, bc = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
              for sh in ((4, 16, 12), (4, 12), (12,)))
for name, x_pl, params_on_mesh in (
        ("sequence", (Shard(0), Shard(1)), True),
        ("channels", (Replicate(), Shard(2)), True),
        ("plain weights", (Shard(1), Shard(1)), False)):
    want = S._causal_depthwise_conv(xc, wc, bc)
    one = [t.clone().requires_grad_(True) for t in (xc, wc, bc)]
    S._causal_depthwise_conv(*one).sum().backward()
    px = distribute_tensor(xc, m22, x_pl).requires_grad_(True)
    wb = [(distribute_tensor(t, m22, (Replicate(), Replicate()))
           if params_on_mesh else t.clone()).requires_grad_(True)
          for t in (wc, bc)]
    got = S._causal_depthwise_conv(px, *wb)
    got.sum().backward()
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    sites["conv/" + name] = [
        [str(got.placements)], torch.equal(got.full_tensor(), want),
        [float((whole(a.grad) - b.grad).abs().max() / b.grad.abs().max())
         for a, b in zip([px, *wb], one)]]
# -- decode attention with the heads split, and the Mamba2 block's SSD
rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
from repro_torch.launch.costs import LocalCosts
for g, sq, per_row, quant in ((2, 1, False, False), (2, 2, True, False),
                              (1, 1, True, False), (2, 1, False, True),
                              (1, 1, False, True)):
    q = torch.from_numpy(rng.standard_normal((4, sq, 4, 8)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((4, 16, g, 8))
                               .astype(np.float32)) for _ in range(2))
    kw = {}
    if quant:
        kc, vc = (torch.round(t * 20).clamp(-127, 127) for t in (kc, vc))
        kw = {n: torch.from_numpy(rng.uniform(0.01, 0.1, (4, g))
                                  .astype(np.float32)) for n in ("kscale", "vscale")}
    n = torch.tensor([16, 9, 12, 5]) if per_row else 11
    want = A.decode_attention(q, kc, vc, n, window=8, **kw)
    cache_pl = (Shard(0), Shard(2) if g == 2 else Shard(1))
    moved = []
    for reps in (1, 4):     # the cache as it is, and 4x as long
        with LocalCosts() as costs:
            got = A.decode_attention(
                distribute_tensor(q, m22, (Shard(0), Shard(2))),
                *(distribute_tensor(torch.cat([t] * reps, 1), m22, cache_pl)
                  for t in (kc, vc)), n, window=8,
                **{k: distribute_tensor(v, m22, (Shard(0), Replicate()))
                   for k, v in kw.items()})
        moved.append(sum(costs.collectives.values()))
        if reps == 1:
            sites[f"decode/g{g}/sq{sq}/rows{per_row}/int8{quant}"] = [
                [str(got.placements)], torch.equal(got.full_tensor(), want),
                [rel(got.full_tensor(), want)]]
    sites[f"decode/g{g}/sq{sq}/rows{per_row}/int8{quant}"][2] += moved
scfg = dataclasses.replace(get_config("mamba2-370m").smoke(), ssm_chunk=8)
sp = S.init_mamba2(torch.Generator().manual_seed(0), scfg, torch.float32, "cpu")
u = torch.from_numpy(rng.standard_normal((4, 32, scfg.d_model)).astype(np.float32))
for init in (False, True):
    S0 = (torch.from_numpy(rng.standard_normal(
        (4, scfg.ssm_heads, scfg.ssm_state, scfg.ssm_headdim))
        .astype(np.float32)) if init else None)
    one = {k: v.clone().requires_grad_(True) for k, v in sp.items()}
    u1 = u.clone().requires_grad_(True)
    want, wst = S.mamba2_forward(one, scfg, u1, initial_state=S0)
    want.sum().backward()
    pp = {k: distribute_tensor(v, m22, [Replicate()] * 2).requires_grad_(True)
          for k, v in sp.items()}
    pu = distribute_tensor(u, m22, (Shard(0), Replicate())).requires_grad_(True)
    pS0 = (None if S0 is None else
           distribute_tensor(S0, m22, (Shard(0), Shard(1))))
    with use_mesh(m22):
        got, gst = S.mamba2_forward(pp, scfg, pu, initial_state=pS0)
        got.sum().backward()
    errs = [rel(got.full_tensor(), want), rel(gst["S"].full_tensor(), wst["S"]),
            rel(pu.grad.full_tensor(), u1.grad)]
    errs += [rel(pp[k].grad.full_tensor(), one[k].grad)
             for k in ("A_log", "D", "dt_bias", "in_proj", "conv_w")]
    sites[f"ssd/init{init}"] = [[str(gst["S"].placements)], None, errs]
# -- the gated MLP of a sequence-split x, its ff split over "model" or not
from repro_torch.models import layers as L
xm = torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))
wi, wo = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32) * 0.3)
          for sh in ((16, 2, 24), (24, 16)))
for name, ff_split in (("ff split", True), ("ff whole", False)):
    one = [t.clone().requires_grad_(True) for t in (xm, wi, wo)]
    want = L.gated_mlp(*one, "geglu")
    want.sum().backward()
    px = distribute_tensor(xm, m22, (Shard(0), Shard(1))).requires_grad_(True)
    pwi = distribute_tensor(wi, m22, (Replicate(), Shard(2) if ff_split
                                      else Replicate())).requires_grad_(True)
    pwo = distribute_tensor(wo, m22, (Replicate(), Shard(0) if ff_split
                                      else Replicate())).requires_grad_(True)
    with use_mesh(m22):
        got = L.gated_mlp(px, pwi, pwo, "geglu")
        got.sum().backward()
    sites["mlp/" + name] = [[str(got.placements)], None, [rel(
        got.full_tensor(), want)] + [rel(a.grad.full_tensor(), b.grad)
                                     for a, b in zip((px, pwi, pwo), one)]]
out["sites"] = sites
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


@pytest.mark.parametrize("case", ["project/batch", "project/sequence",
                                  "project/cross"])
def test_project_with_split_heads_matches_no_mesh(ranks, case):
    """``attention._project`` with wq, wk, wv split along their heads over
    "model" and x split along its batch (DTensor's own ops), along batch
    and sequence (the branch torch 2.11's DTensor needs: no flattening of
    a split sequence), or, so split, projecting encoder states: q, k, v
    split along their heads, bit for bit the plain path's values, and dx,
    dwq within ``test_torch_models.py``'s f32 gradient tolerance (2e-5 of
    the largest magnitude: the shards sum the batch in another order)."""
    for out in ranks:
        placements, equal, errs = out["sites"][case]
        assert placements == ["(Shard(dim=0), Shard(dim=2))"] * 3, placements
        assert equal, case
        assert all(e <= 2e-5 for e in errs), (case, errs)


@pytest.mark.parametrize("case", ["conv/sequence", "conv/channels",
                                  "conv/plain weights"])
def test_conv_of_a_split_sequence_matches_no_mesh(ranks, case):
    """``ssm._causal_depthwise_conv`` of a DTensor (the sequence split over
    "model", the channels split, or weights not on the mesh): the sequence
    gathered whole on each shard, the batch and channel splits kept, the
    values bit for bit the plain path's, and dx, dw, db within 2e-5 (the
    shards sum the batch in another order)."""
    for out in ranks:
        placements, equal, errs = out["sites"][case]
        assert equal, case
        assert all(e <= 2e-5 for e in errs), (case, errs)
    want = {"conv/sequence": "(Shard(dim=0), Replicate())",
            "conv/channels": "(Replicate(), Shard(dim=2))",
            "conv/plain weights": "(Replicate(), Replicate())"}[case]
    assert ranks[0]["sites"][case][0] == [want]


@pytest.mark.parametrize("case", [
    "decode/g2/sq1/rowsFalse/int8False", "decode/g2/sq2/rowsTrue/int8False",
    "decode/g1/sq1/rowsTrue/int8False", "decode/g2/sq1/rowsFalse/int8True",
    "decode/g1/sq1/rowsFalse/int8True"])
def test_decode_attention_with_split_heads_matches_no_mesh(ranks, case):
    """``attention.decode_attention`` of a q split along its heads over
    "model" (the branch torch 2.11's DTensor needs: no flattening of split
    groups in the batched products), scalar or per-row lengths, one or two
    new tokens, a window, and int8 caches with their scales, placed as q.
    Caches split along their KV heads: bit for bit the plain path's values
    (each row and head attends as on one device).  For one KV head, caches
    split along their sequence: the split is kept (each device attends
    over its slice and the slices merge by their log-sum-exp, as flash
    decoding does), so the values are the plain path's within ``FP32_ATOL``
    of the largest (the softmax sums in two steps), and the bytes a device
    moves do not grow with the cache (a cache four times as long moves the
    same; gathering it would move four times as much)."""
    for out in ranks:
        placements, equal, (err, moved, moved_4x) = out["sites"][case]
        assert placements == ["(Shard(dim=0), Shard(dim=2))"], placements
        if "/g2/" in case:
            assert equal, case
        else:
            assert err <= FP32_ATOL and moved == moved_4x, (err, moved,
                                                            moved_4x)


@pytest.mark.parametrize("init", [False, True])
def test_mamba2_block_with_split_heads_matches_no_mesh(ranks, init):
    """``ssm.mamba2_forward`` under ``use_mesh`` on (2, 2): the batch over
    "data" and the SSD's heads over "model" (``_ssd_on_mesh``, the branch
    torch 2.11's DTensor needs), from zeros or a given state: the output
    and the final state, and the gradients of the input and of A_log, D,
    dt_bias, in_proj and conv_w, within ``test_torch_models.py``'s f32
    tolerances (1e-5 of the largest magnitude, 2e-5 for gradients: the
    shards sum the batch and the heads in other orders); the state placed
    by rows and heads."""
    for out in ranks:
        placements, _, errs = out["sites"][f"ssd/init{init}"]
        assert placements == ["(Shard(dim=0), Shard(dim=1))"], placements
        assert all(e <= 1e-5 for e in errs[:2]), errs
        assert all(e <= 2e-5 for e in errs[2:]), errs


@pytest.mark.parametrize("case", ["ff split", "ff whole"])
def test_gated_mlp_of_a_split_sequence_matches_no_mesh(ranks, case):
    """``layers.gated_mlp`` of an x split along batch and sequence (the
    branch torch 2.11's DTensor needs: no flattening of a split sequence),
    its ff split over "model" (the sequence gathered there, the output
    reduced) or whole: the output placed by the caller's ``constrain`` (the
    batch over "data"), and it and dx, dwi, dwo within the f32 tolerances
    (1e-5, 2e-5 for gradients, of the largest magnitude)."""
    for out in ranks:
        placements, _, errs = out["sites"]["mlp/" + case]
        assert placements == ["(Shard(dim=0), Replicate())"], placements
        assert errs[0] <= 1e-5 and all(e <= 2e-5 for e in errs[1:]), errs


def test_local_slices_match_dtensor(ranks):
    for out in ranks:
        assert all(out["local_slices"])
