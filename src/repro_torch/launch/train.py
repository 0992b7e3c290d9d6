"""Training driver: synthetic data -> train step -> checkpoints.

Runs real steps on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``).  Demonstrates the fault-tolerance loop: resume from the
newest repairable checkpoint (RRNS repair-on-restore,
``train/checkpointer.py``), policy-driven async saves on a single
background writer, and a step-time watchdog (straggler hook).  With
``--rns-allreduce`` every step aggregates its gradients through the
paper's exact RNS codec over the default process group: one int32
all-reduce of the whole gradient tree, the codec kernels on the card.  The
group is made here when none exists: NCCL on the card, gloo on the CPU,
rank and world from the environment when ``torchrun`` set them, else a
group of one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --steps 30 --ckpt-dir /tmp/ck --ckpt-policy 2@10,5,60s \
        --ckpt-keep 3 [--rns-allreduce]

    # RRNS locate-and-correct transport with an injected wire corruption
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --steps 4 --rns-correct --inject-corrupt-step 2

    # corrupt one RRNS channel of the newest checkpoint, then watch the
    # restore repair it in stride (2 channels: refuse + fall back)
    PYTHONPATH=src python -m repro_torch.launch.train --steps 10 \
        --ckpt-dir /tmp/ck --inject-ckpt-corrupt 1

    # data parallel over two processes on the CPU
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
        --rns-allreduce

It prints one line a step and, last, one JSON summary line: the losses,
the MoE aux losses (0 for the other families), the step times, tokens/s,
the peak device memory, the step it started from and, with ``--ckpt-dir``,
the restore's report and each save's timings (``ckpt_saves``).
``--profile-start-step/--profile-steps`` capture a ``torch.profiler``
trace of that window of steps (``launch/profiling.py``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..dist.grad_codec import GradCodec
from ..models import init_params
from ..train import checkpointer as ckpt
from ..train.data import Prefetcher, SyntheticLM
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import make_train_step
from .profiling import ProfilerWindow

__all__ = ["make_rns_dp_step", "init_group", "main"]


def _corrupt_wire(codec):
    """Transport hook that moves one residue of the local wire buffer —
    element 0's channel-0 residue by +1 mod m_1, a real and still canonical
    corruption — in place (the injection half of the ``--rns-correct``
    demo; the repair half must undo it exactly)."""
    m0 = int(codec.base.moduli[0])

    def hook(buf):
        # raw channel-major (n_channels, B) residues of the wire array
        buf[0, 0] = torch.remainder(buf[0, 0] + 1, m0)
        return buf

    return hook


def make_rns_dp_step(cfg, opt_cfg, codec, *, repair=False, inject=False,
                     group=None):
    """Data-parallel step with the paper's RNS-exact gradient all-reduce
    over ``group`` (the default process group when None): each rank takes
    its equal share of the batch rows, its gradients encode into ONE
    channel-major int32 wire buffer (the codec kernel on the card), the
    whole tree moves in a single all-reduce, and the decode runs at the
    optimizer boundary.  Returns ``(step, world)``.

    repair=True adds the RRNS locate-and-correct pass on the wire buffer
    (needs a ``correct=True`` codec); inject=True corrupts one residue
    first, so the step shows in-flight repair."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    step = make_train_step(
        cfg, opt_cfg, rns_codec=codec, group=group, rns_repair=repair,
        transport_hook=_corrupt_wire(codec) if inject else None,
    )

    def dp_step(params, opt_state, batch):
        local = {}
        for k, v in batch.items():
            if v.shape[0] % world:
                raise ValueError(f"batch of {v.shape[0]} rows does not split "
                                 f"over {world} ranks")
            rows = v.shape[0] // world
            local[k] = v[rank * rows : (rank + 1) * rows]
        return step(params, opt_state, local)

    return dp_step, world


def init_group(device) -> bool:
    """Make the default process group unless one exists; True when this
    call made it.  NCCL for a CUDA device, gloo otherwise; ``torchrun``'s
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) when set, else
    a group of one over an in-memory store."""
    if dist.is_initialized():
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def main(argv=None):
    """Run the driver; returns ``(params, summary)``, the final parameters
    and the dict printed as the last line."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--ckpt-policy", default="",
                    help="save-policy grammar 'N | N@M | Ns | Nm, ...' "
                         "(e.g. '2@10,5,60s'); overrides --save-every")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="retention GC: keep only the newest K committed "
                         "steps (0 = keep everything)")
    ap.add_argument("--inject-ckpt-corrupt", type=int, default=0,
                    metavar="K",
                    help="corrupt K RRNS channels of the newest saved "
                         "checkpoint before restoring: 1 demonstrates "
                         "locate-and-correct, 2 the refuse-and-fall-back "
                         "path (needs --ckpt-dir)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--rns-allreduce", action="store_true",
                    help="use the paper's RNS gradient aggregation")
    ap.add_argument("--rns-correct", action="store_true",
                    help="RNS aggregation with the second redundant modulus "
                         "and in-flight RRNS repair of corrupted wire "
                         "buffers (implies --rns-allreduce)")
    ap.add_argument("--inject-corrupt-step", type=int, default=-1,
                    metavar="N",
                    help="with --rns-correct: corrupt one wire residue at "
                         "step N to demonstrate the in-place repair")
    ap.add_argument("--unfused-codec", action="store_true",
                    help="the exact f64 encode/decode path for the RNS "
                         "codec instead of the codec kernels")
    ap.add_argument("--watchdog-x", type=float, default=3.0,
                    help="warn when a step exceeds x * median step time")
    ap.add_argument("--profile-start-step", type=int, default=-1,
                    metavar="N",
                    help="train step at which to start a torch.profiler "
                         "trace (-1 disables; a start step + a step count)")
    ap.add_argument("--profile-steps", type=int, default=0, metavar="N",
                    help="train steps to capture in the profiler window")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="profiler artifact directory (default: "
                         "--ckpt-dir when set, else '.')")
    ap.add_argument("--device", default="cuda",
                    help="device of the parameters and the steps "
                         "(default cuda)")
    args = ap.parse_args(argv)
    if args.inject_corrupt_step >= 0 and not args.rns_correct:
        ap.error("--inject-corrupt-step needs --rns-correct (there is no "
                 "repair path to demonstrate without it)")
    if args.inject_ckpt_corrupt and not args.ckpt_dir:
        ap.error("--inject-ckpt-corrupt needs --ckpt-dir (there is no "
                 "checkpoint to corrupt without one)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg.validate()
    opt_cfg = AdamWConfig(warmup=5, decay_steps=max(args.steps, 10))
    device = _device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)

    params = init_params(cfg, 0, device)
    opt_state = adamw_init(params)
    start_step, restored = 0, None
    if args.ckpt_dir:
        if args.inject_ckpt_corrupt:
            latest = ckpt.discover_latest(args.ckpt_dir)
            if latest is None:
                ap.error("--inject-ckpt-corrupt: nothing saved under "
                         f"{args.ckpt_dir} yet")
            ckpt.inject_channel_corruption(
                os.path.join(args.ckpt_dir, f"step_{latest}"),
                leaf=0, channels=tuple(range(args.inject_ckpt_corrupt)),
            )
            print(f"[inject] corrupted {args.inject_ckpt_corrupt} RRNS "
                  f"channel(s) of step {latest}, leaf 0, element 0")
        timings, t0 = {}, time.perf_counter()
        try:
            # restore directly (one scan+read+hash of the checkpoint);
            # probing latest first would read and decode it all twice
            tree, start_step, extra, rep = ckpt.restore(
                args.ckpt_dir, {"params": params, "opt": opt_state},
                device=device, timings=timings)
        except FileNotFoundError:
            pass  # fresh run: nothing restorable yet
        else:
            params, opt_state = tree["params"], tree["opt"]
            restored = dict(rep, step=start_step, **timings,
                            seconds=time.perf_counter() - t0)
            print(f"[resume] restored step {start_step}: "
                  f"{rep['leaves']} leaves, "
                  f"repaired_leaves={rep['repaired_leaves']} "
                  f"repaired_elements={rep['repaired_elements']} "
                  f"steps_skipped={rep['steps_skipped']}")
            opt_step = int(opt_state["step"])
            if opt_step != start_step:
                print(f"[resume] WARNING: optimizer step {opt_step} != "
                      f"checkpoint step {start_step}")
    made_group, inject_fn, world = False, None, 1
    if args.rns_allreduce or args.rns_correct:
        made_group = init_group(device)
        codec = GradCodec.make(world=max(dist.get_world_size(), 2),
                               fused=not args.unfused_codec,
                               correct=args.rns_correct)
        step_fn, world = make_rns_dp_step(cfg, opt_cfg, codec,
                                          repair=args.rns_correct)
        if args.rns_correct and args.inject_corrupt_step >= 0:
            inject_fn, _ = make_rns_dp_step(cfg, opt_cfg, codec,
                                            repair=True, inject=True)
        reds = "+".join(str(r) for r in codec.redundant)
        print(f"[rns] RNS gradient all-reduce over {world} rank(s), "
              f"base n={codec.base.n} moduli, redundant {reds}, "
              f"bucketed single all-reduce, "
              f"{'kernel' if codec.use_fused else 'f64'} codec"
              + (", RRNS locate-and-correct armed" if args.rns_correct
                 else ""))
    else:
        step_fn = make_train_step(cfg, opt_cfg,
                                  microbatches=args.microbatches)

    loader = SyntheticLM(cfg, seq=args.seq, batch=args.batch)
    prefetch = Prefetcher(loader, start_step=start_step)
    saver = None
    if args.ckpt_dir:
        policy = args.ckpt_policy or str(args.save_every)
        saver = ckpt.Checkpointer(args.ckpt_dir, policy,
                                  keep=args.ckpt_keep or None)
        print(f"[ckpt] policy {policy!r}, "
              f"keep {'all' if not args.ckpt_keep else args.ckpt_keep}, "
              f"async RRNS-coded saves under {args.ckpt_dir}")
    window = ProfilerWindow(
        args.profile_start_step, args.profile_steps,
        args.profile_dir or args.ckpt_dir or ".", label="train",
        device=device,
    )
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    summary = {"arch": cfg.name, "device": str(device), "world": world,
               "rns": bool(args.rns_allreduce or args.rns_correct),
               "batch": args.batch, "seq": args.seq,
               "start_step": start_step, "losses": [],
               "auxes": [], "gnorms": [], "step_ms": [], "tokens_per_s": []}
    if restored is not None:
        summary["restored"] = restored
    try:
        for _ in range(start_step, args.steps):
            window.step()
            step, batch = prefetch.next()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            if on_card:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn = (inject_fn if inject_fn is not None
                  and step == args.inject_corrupt_step else step_fn)
            params, opt_state, metrics = fn(params, opt_state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            if on_card:
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            summary["losses"].append(metrics["loss"])
            summary["auxes"].append(metrics["aux"])
            summary["gnorms"].append(metrics["gnorm"])
            summary["step_ms"].append(1e3 * dt)
            summary["tokens_per_s"].append(args.batch * args.seq / dt)
            times = summary["step_ms"]
            med = sorted(times)[len(times) // 2]
            if len(times) > 3 and 1e3 * dt > args.watchdog_x * med:
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {med / 1e3:.2f}s) — straggler suspected")
            if "repaired" in metrics:
                for k in ("repaired", "unrepairable"):
                    summary.setdefault(k, []).append(int(metrics[k]))
            if metrics.get("repaired", 0) > 0:
                print(f"[rns-correct] repaired "
                      f"{int(metrics['repaired'])} corrupted wire "
                      f"value(s) in place at step {step} — no rollback")
            if metrics.get("unrepairable", 0) > 0:
                print(f"[rns-correct] step {step}: "
                      f"{int(metrics['unrepairable'])} element(s) beyond "
                      f"single-channel repair — checkpoint rollback advised")
            print(f"step {step:4d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['gnorm']:.3f} {dt*1e3:.0f}ms", flush=True)
            if saver is not None:
                saver.maybe_save(step + 1,
                                 {"params": params, "opt": opt_state},
                                 extra={"opt_step": int(metrics["opt_step"])})
    finally:
        window.close()
        prefetch.close()
        try:
            if saver is not None:
                saver.close()  # drain the queue; re-raise any failed save
        finally:
            if made_group:
                dist.destroy_process_group()
    if saver is not None:
        summary["ckpt_saves"] = saver.saves
    if window.enabled and window.artifact:
        print(f"[profile] captured {window.captured} step(s) under "
              f"{window.artifact}")
    summary["max_memory_allocated"] = (
        torch.cuda.max_memory_allocated(device) if on_card else None)
    print(json.dumps(summary), flush=True)
    return params, summary


if __name__ == "__main__":
    main()
