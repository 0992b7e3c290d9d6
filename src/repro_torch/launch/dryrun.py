"""Dry run: one step of every (arch x shape x mesh) cell on ``meta``
DTensors over a fake process group, with its per-device memory, flops,
bytes and collectives — the reference's ``repro/launch/dryrun.py``, whose
lower-and-compile becomes a step run under ``launch.costs.LocalCosts``.

The fake group (``torch.testing``'s ``FakeStore``, backend ``"fake"``)
gives one process the production mesh's 256 (or 512) ranks; its
collectives move no data, and ``meta`` tensors hold no memory, so the run
proves shapes, placements and collective counts, never values.  The
parameters, the optimizer state (f32 masters, ZeRO-1 moments), the batch
and the cache are placed by ``dist.sharding``'s spec trees; the step is
the port's own: ``make_train_step`` (gradients pinned to the parameter
placements), ``prefill`` or ``decode_step`` under ``use_mesh``.  The fake
group must be the process's only group, so run this in a process of its
own.

Record keys are the reference's where they still mean something:
``memory.*`` per device (``per_device_bytes`` = the arguments' local bytes
plus the step's peak of live local tensors: eager torch holds the old
state until the step returns, so nothing is aliased), ``collectives``,
``roofline`` (against the H100's spec sheet, ``costs.HW``),
``model_flops_*``, ``useful_flops_ratio`` and ``knobs``.  ``fits_hbm``
compares with the H100's 80 GB.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --auto-fit
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ALIASES, SHAPES, get_config, shape_cells
from ..dist import _tree
from ..dist.act_sharding import use_mesh
from ..dist.sharding import (batch_specs, cache_specs,
                             named_shardings, opt_state_specs, param_specs,
                             place_host)
from ..models import abstract_params, decode_step, prefill
from ..serve.serve_step import cache_zeros, prompt_zeros
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import make_train_step
from .costs import HW, LocalCosts, roofline
from .mesh import make_production_mesh, required_devices

__all__ = ["count_params", "model_flops", "train_batch_abstract",
           "fake_world", "run_cell", "run_cell_autofit", "main"]

HBM_PER_CARD = HW["hbm_bytes"]
DEFAULT_OUT = "experiments/dryrun_torch"


# ----------------------------------------------------------------- helpers
def count_params(cfg, params_abs):
    """(total, active) parameter counts; MoE experts scale by top_k/E."""
    total = active = 0
    for name, leaf in _tree.flatten_named(params_abs):
        keys = name.split("/")
        n = leaf.numel()
        total += n
        if "moe" in keys and keys[-1] in ("wi", "wo"):
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    return total, int(active)


def model_flops(cfg, params_abs, kind: str, batch: int, seq: int) -> float:
    """6·N_active·D (train) or 2·N_active·D (serve), global."""
    _, active = count_params(cfg, params_abs)
    tokens = batch * (1 if kind == "decode" else seq)
    return (6.0 if kind == "train" else 2.0) * active * tokens


def train_batch_abstract(cfg, batch: int, seq: int):
    """The training batch's tensors on ``meta``."""
    spec = {"tokens": torch.empty((batch, seq + 1), dtype=torch.int32,
                                  device="meta")}
    if cfg.family == "vlm":
        spec["patches"] = torch.empty((batch, cfg.n_patches, cfg.d_model),
                                      device="meta")
    if cfg.family == "encdec":
        spec["frames"] = torch.empty((batch, cfg.enc_frames, cfg.d_model),
                                     device="meta")
    return spec


def fake_world(size: int) -> None:
    """Make a fake process group of ``size`` ranks this process's default
    group (rank 0), replacing a fake one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process whose only "
                               "group is its fake one")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _place(tree, specs, mesh):
    sh = named_shardings(specs, mesh)
    return _tree.tree_map(
        lambda t, s: place_host(t, s) if isinstance(t, torch.Tensor) else t,
        tree, sh)


def _local_bytes(tree) -> int:
    total = 0
    for t in _tree.flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if hasattr(t, "to_local") else t
            total += loc.numel() * loc.element_size()
    return total


def _cell_config(arch, kind, kv_quant, seq_parallel):
    cfg = get_config(arch)
    if (kv_quant and kind != "train" and not cfg.window
            and cfg.family in ("dense", "vlm", "moe")):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if seq_parallel and cfg.family in ("dense", "vlm", "moe"):
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    # bf16 weights everywhere; training keeps f32 masters inside the
    # ZeRO-sharded optimizer state (the reference's production layout)
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def step_cell(arch: str, shape_name: str, mesh, *, microbatches: int = 1,
              kv_quant: bool = False, seq_parallel: bool = False):
    """Place one cell's state on ``mesh`` and run its step under
    ``LocalCosts``: ``(cfg, params_abs, costs, memory, (kind, seq,
    batch))``."""
    cell = SHAPES[shape_name]
    kind, seq, batch = cell["kind"], cell["seq"], cell["batch"]
    cfg = _cell_config(arch, kind, kv_quant, seq_parallel)
    params_abs = abstract_params(cfg)
    pspecs = param_specs(params_abs, mesh, n_experts=cfg.n_experts)
    params = _place(params_abs, pspecs, mesh)
    if kind == "train":
        opt_abs = adamw_init(params_abs, master=True)
        zspec = opt_state_specs(params_abs, pspecs, mesh, zero1=cfg.zero1)
        opt = {k: _place(opt_abs[k], zspec, mesh)
               for k in ("m", "v", "master")}
        opt["step"] = opt_abs["step"]
        data = train_batch_abstract(cfg, batch, seq)
        data = _place(data, batch_specs(data, mesh), mesh)
        args = (params, opt, data)
        pin = (None if os.environ.get("RNS_NO_GRAD_PIN")
               else named_shardings(pspecs, mesh))
        fn = make_train_step(cfg, AdamWConfig(), microbatches=microbatches,
                             grad_shardings=pin, mesh=mesh)
    elif kind == "prefill":
        cache_len = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
        data = prompt_zeros(cfg, batch, seq, "meta")
        data = _place(data, batch_specs(data, mesh), mesh)
        args = (params, data)
        fn = lambda p, b: prefill.__wrapped__(cfg, p, b, cache_len)
    else:
        cache = cache_zeros(cfg, batch, seq, "meta")
        cache = _place(cache, cache_specs(cache, mesh), mesh)
        tokens = torch.empty((batch, 1), dtype=torch.int32, device="meta")
        tokens = _place(tokens, batch_specs(tokens, mesh), mesh)
        args = (params, cache, tokens, seq - 1)
        fn = lambda p, c, t, pos: decode_step.__wrapped__(cfg, p, c, t, pos)
    argument = _local_bytes(args)
    with use_mesh(mesh), torch.no_grad() if kind != "train" else \
            torch.enable_grad(), LocalCosts() as lc:
        out = fn(*args)
        output = _local_bytes(out)
        del out
    costs = lc.record()
    memory = {
        "argument_bytes": argument,
        "output_bytes": output,
        "temp_bytes": costs["peak_live_bytes"],
        "alias_bytes": 0,
        "per_device_bytes": argument + costs["peak_live_bytes"],
    }
    memory["fits_hbm"] = bool(memory["per_device_bytes"] < HBM_PER_CARD)
    return cfg, params_abs, costs, memory, (kind, seq, batch)


def run_cell(arch: str, shape_name: str, mesh_name: str, *, microbatches=1,
             kv_quant=False, seq_parallel=False, mesh=None):
    """One cell's record: on the production mesh ``mesh_name`` names, over
    a fake group, or on ``mesh`` when given (``mesh_name`` then only
    labels the record)."""
    if mesh is None:
        multi = mesh_name == "multi"
        fake_world(required_devices(multi_pod=multi))
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    ndev = mesh.size()
    t0 = time.time()
    cfg, params_abs, costs, memory, (kind, seq, batch) = step_cell(
        arch, shape_name, mesh, microbatches=microbatches, kv_quant=kv_quant,
        seq_parallel=seq_parallel)
    run_s = time.time() - t0
    coll = costs["collectives"]
    terms = roofline(costs, coll)
    mf = model_flops(cfg, params_abs, kind, batch, seq)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "devices": ndev,
        "kind": kind,
        "seq": seq,
        "global_batch": batch,
        "run_s": round(run_s, 2),
        "local_ops": costs["local_ops"],
        "memory": memory,
        "collectives": coll,
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / ndev,
        "useful_flops_ratio": (
            (mf / ndev) / terms["flops_per_device"]
            if terms["flops_per_device"] else 0.0
        ),
        "knobs": {"microbatches": microbatches, "remat": cfg.remat,
                  "zero1": cfg.zero1, "window_cache": cfg.window_cache,
                  "kv_quant": cfg.kv_quant, "seq_parallel": cfg.seq_parallel},
    }


def run_cell_autofit(arch, shape, mesh_name, *, microbatches=1,
                     kv_quant=False):
    """The reference's ladder: train cells climb microbatches 1 -> 4 -> 8
    -> 16, serve cells turn on the int8 KV cache, then sequence
    parallelism, until the cell fits; the first fitting record, or the
    last attempt."""
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        mbs = [mb for mb in (1, 4, 8, 16) if mb >= microbatches]
        ladder = [{"microbatches": mb} for mb in (mbs or [microbatches])]
    else:
        cfg = get_config(arch)
        quantizable = not cfg.window and cfg.family in ("dense", "vlm", "moe")
        ladder = [] if kv_quant and quantizable else [{}]
        if quantizable:
            ladder.append({"kv_quant": True})
            ladder.append({"kv_quant": True, "seq_parallel": True})
        elif cfg.family in ("dense", "vlm", "moe"):
            ladder.append({"seq_parallel": True})
    rec = None
    for knobs in ladder:
        rec = run_cell(arch, shape, mesh_name, **knobs)
        if rec["memory"]["fits_hbm"]:
            return rec
        print(f"[autofit] {arch}/{shape}/{mesh_name} over HBM at {knobs}; "
              f"escalating", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--auto-fit", action="store_true",
                    help="escalate microbatches (train) / int8 KV cache "
                         "(serve) until the cell fits HBM")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ALIASES for s in shape_cells(get_config(a))]
    else:
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        for mesh_name in meshes:
            tag = f"{arch}__{shape}__{mesh_name}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
                continue
            print(f"[cell] {tag} ...", flush=True)
            try:
                run = run_cell_autofit if args.auto_fit else run_cell
                rec = run(arch, shape, mesh_name,
                          microbatches=args.microbatches,
                          kv_quant=args.kv_quant)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r, mem = rec["roofline"], rec["memory"]
                print(
                    f"[ok]   {tag}: run={rec['run_s']}s "
                    f"bottleneck={r['bottleneck']} "
                    f"compute={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                    f"coll={r['collective_s']:.4f}s "
                    f"per_device={mem['per_device_bytes']} "
                    f"fits={mem['fits_hbm']}",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print("\nALL CELLS OK")


if __name__ == "__main__":
    main()
