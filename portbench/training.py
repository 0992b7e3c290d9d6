"""What the training entries (``portbench/entries/{plain,rns,rrns}.py``)
share: the run of a training step, its faults and its control.

A run: the state made on the device from the seed, the step built by the
entry, ``setup_steps`` steps through the window's own call on distinct
batches (their loss, first gradient and parameter change kept for the
check), the window (steps back to back, synchronised at both ends only),
on a traced run the stage probe over the window and a few steps under the
profiler after it; then, the program's state freed, the reference runs
the same set-up steps and ``check`` compares.
"""
from __future__ import annotations

import gc
import json
import math
import time

import torch

from . import check, counts, inputs, trace as trace_mod
from .reference import rrns, train as ref_train

__all__ = ["run", "model_config", "optimizer_config", "grad_codec",
           "reference", "control", "state_unchanged", "half_batch",
           "repair_skipped", "TRACE_STEPS"]

TRACE_STEPS = 3


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(model: dict):
    """The port's ``ModelConfig`` of a configuration's model block."""
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**model).validate()


def optimizer_config(traffic: dict):
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(**traffic["optimizer"])


def grad_codec(traffic: dict):
    """The port's ``GradCodec`` of a traffic mix's ``codec``."""
    from repro_torch.dist.grad_codec import GradCodec

    c = traffic["codec"]
    return GradCodec.make(world=c["world"], n=c["n"], bits=c["bits"],
                          frac_bits=c["frac_bits"], correct=c["correct"])


def reference(family, m, traffic, seed, pool, device, mm=None) -> dict:
    """The reference's readings over the set-up steps, in f32 with TF32
    off, from the same parameters and batches (``mm``: the products'
    precision, the control's fp8)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p0 = inputs.flatten(inputs.init_params(family, m, seed, device))
    n = traffic["setup_steps"]
    out = {"losses": []}

    def on_step(t, loss, grads, params):
        out["losses"].append(loss)
        if t == 1:
            out["grad"] = {k: v.tolist() for k, v in check.slice_norms(
                grads, family.STACKED).items()}
        if t == n:
            out["update"] = {k: v.tolist() for k, v in check.slice_norms(
                {k: params[k] - p0[k] for k in p0}, family.STACKED).items()}

    ref_train.reference_steps(family.logits, m, p0,
                              [pool[t % len(pool)] for t in range(n)],
                              traffic["optimizer"], traffic.get("codec"),
                              mm=mm, on_step=on_step)
    return out


def control(ctx) -> dict:
    """The control's numbers: the reference with fp8 products in the
    program's place, against the f32 reference."""
    from .reference.fp8 import fp8_mm

    m, tr = ctx.model, ctx.traffic
    pool = inputs.batch_pool(m["vocab"], tr, ctx.seed, ctx.device)
    ref = reference(ctx.family, m, tr, ctx.seed, pool, ctx.device)
    ctl = reference(ctx.family, m, tr, ctx.seed, pool, ctx.device, mm=fp8_mm)
    return check.compare(ctl, ref)


def state_unchanged(step):
    """The fault: the step's outputs dropped, parameters and moments kept."""
    def run(params, opt_state, batch):
        return params, opt_state, step(params, opt_state, batch)[2]
    return run


def half_batch(step):
    """The fault: half of the batch's rows left out."""
    def run(params, opt_state, batch):
        t = batch["tokens"]
        return step(params, opt_state, {"tokens": t[: t.shape[0] // 2]})
    return run


def repair_skipped(step):
    """The fault: the RRNS pass counts nothing and repairs nothing."""
    from repro_torch.train import train_step

    def skipped(codec, wire):
        return torch.zeros(2, dtype=torch.int64, device=wire.residues.device)

    def run(params, opt_state, batch):
        orig, train_step._repair = train_step._repair, skipped
        try:
            return step(params, opt_state, batch)
        finally:
            train_step._repair = orig
    return run


def run(ctx, build) -> dict:
    """One run of a training entry; ``build(ctx) -> (step, hook)`` makes
    the entry's step and, on a repairing entry, its wire fault hook."""
    from repro_torch.train.optimizer import adamw_init

    m, tr, dev, fam = ctx.model, ctx.traffic, ctx.device, ctx.family
    cuda = dev.type == "cuda"
    phases = ctx.phases
    probe = None
    if ctx.trace:
        from .probe import StageProbe

        probe = StageProbe(dev).__enter__()
    try:
        step, hook = build(ctx)
        if ctx.wrap_step is not None:
            step = ctx.wrap_step(step)
        params = inputs.init_params(fam, m, ctx.seed, dev)
        opt_state = adamw_init(params)
        pool = inputs.batch_pool(m["vocab"], tr, ctx.seed, dev)
        _sync(dev)
        phases["state"] = time.perf_counter() - ctx.t0
        P = pool.shape[0]
        readings = check.ProgramReadings(tr["optimizer"], fam.STACKED)

        def run_step(i):
            nonlocal params, opt_state
            params, opt_state, met = step(params, opt_state,
                                          {"tokens": pool[i % P]})
            if hook is not None:
                hook.collect(met)
            return met

        for t in range(1, tr["setup_steps"] + 1):
            met = run_step(t - 1)
            readings.after_step(t, params, opt_state, met, inputs.flatten)
            _sync(dev)
            phases[f"step{t}"] = time.perf_counter() - ctx.t0
        p0 = inputs.flatten(inputs.init_params(fam, m, ctx.seed, dev))
        readings.after_setup(inputs.flatten(params), p0)
        del p0
        n_setup_faults = len(hook.records) if hook else 0
        if probe is not None:
            _sync(dev)
            probe.reset()

        # the window: back to back, synchronised at both ends only
        _sync(dev)
        tw = time.perf_counter()
        setup_s = tw - ctx.t0
        host_ms, losses, i = [], [], tr["setup_steps"]
        while True:
            h = time.perf_counter()
            met = run_step(i)
            host_ms.append((time.perf_counter() - h) * 1e3)
            losses.append(met["loss"])
            i += 1
            if time.perf_counter() - tw >= ctx.seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - tw
        steps = len(host_ms)
        stage_ms = probe.stage_ms() if probe is not None else {}

        traced = (trace_mod.profile_steps(run_step, i, TRACE_STEPS, dev)
                  if ctx.trace else None)
        mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        window_losses = torch.stack(losses).float().tolist()
        prog = readings.host()
        misses = hook.misses(tr["codec"]) if hook else []
    finally:
        if probe is not None:
            probe.__exit__(None, None, None)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    del params, opt_state, step, readings, met, losses
    if hook is not None:
        hook.records.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the program's state is freed
    ref = reference(fam, m, tr, ctx.seed, pool, dev)
    numbers = check.compare(prog, ref)
    window_misses = misses[n_setup_faults:n_setup_faults + steps]
    if hook is not None:
        numbers["repair_miss"] = float(sum(misses))
    failed = sum(1 for j, v in enumerate(window_losses)
                 if not math.isfinite(v)
                 or (window_misses and window_misses[j]))

    tokens = tr["batch"] * tr["seq"]
    ctx.log(json.dumps({"portbench": "run", "cell": ctx.cell.name,
                        "seed": ctx.seed, "shape": [tr["batch"], tr["seq"]],
                        "build_s": ctx.build_s, "setup_s": setup_s,
                        "setup_phases_s": phases, "window_s": window_s,
                        "steps": steps, "memory_peak_bytes": mem_peak}))
    ctx.log(json.dumps({"portbench": "numbers", **numbers}))
    ctx.log(json.dumps({"portbench": "step_host_ms", "ms": host_ms}))
    ctx.log(json.dumps({"portbench": "losses", "setup": prog["losses"],
                        "reference": ref["losses"], "window": window_losses}))
    record = {"steps": steps, "window_s": window_s, "tokens_per_step": tokens,
              "host_call_ms": host_ms, "stage_ms": stage_ms,
              "counts": {"wire_elements": counts.grad_elements(fam, m),
                         "model_flops_per_step": counts.model_flops_per_step(
                             fam, m, tr["batch"], tr["seq"])}}
    if "codec" in tr:
        record["counts"]["channels"] = len(rrns.channel_moduli(tr["codec"]))
        record["counts"]["base_channels"] = tr["codec"]["n"]
    return {"setup_s": setup_s, "attempted": steps, "failed": failed,
            "numbers": numbers, "memory_peak_bytes": mem_peak,
            "values": {"train_tokens_per_s": steps * tokens / window_s,
                       "setup_s": setup_s},
            "record": record, "traced": traced}
