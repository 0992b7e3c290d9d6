"""Continuous-batching serve driver (the reference's DESIGN.md §12):
``serve.batcher.ContinuousBatcher`` over a request workload, synthetic
(``--requests N`` with Poisson arrivals) or replayed from a workload file
(``--trace FILE``).  ``--mode sim`` (the default) runs it on a
deterministic clock of decode-step ticks (one batched decode step a tick),
so every latency number is the same for a given seed; wall-clock
throughput is reported beside it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 8 --slots 4 --arrival-rate 0.5 [--device cpu]

    # gemma3-1b at full width on the card, RRNS fingerprints verified
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --no-smoke --slots 8 --cache-len 2048 --prefill-chunk 256 \
        --requests 16 --prompt-mean 1024 --max-new 64 --arrival-rate 0.5 \
        --rns-verify --inject-wire-corrupt

    # the paged, prefix-sharing pool; then the offline harness and the
    # max-QPS search on it
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --page-size 8 --cache-len 64 --prefill-chunk 8 --rns-verify
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode offline --page-size 8 --cache-len 64 --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mode loadgen --cache-len 64 --qps-iters 1 --phase-requests 4

The flags, the workload file format and the report are the reference's
(``src/repro/launch/serve.py``); a workload drawn from the same ``--seed``
is the same in both packages, and a trace saved by either loads in the
other.  Workload file (JSON lines, one request per line)::

    {"rid": 0, "prompt": [3, 1, 4], "max_new": 16, "eos": 7, "arrival": 0.0}
    {"rid": 1, "family": "crypto", "op": "modexp",
     "a": "0x1234", "b": 65537, "n": "0x10001", "arrival": 2.0}

``prompt`` may be replaced by ``"prompt_len": N`` (N random token ids from
``--seed``).  Crypto-family lines carry big integers as JSON ints or
strings (anything ``int(s, 0)`` takes) and need ``--crypto-slots``; rids
are unique across families.  ``--families llm,crypto`` filters the
workload.  ``--rns-verify`` arms the engine's fingerprints (verified at
every retirement); ``--inject-wire-corrupt`` then corrupts one stored wire
buffer after the run and shows detect -> repair -> re-verify.  The crypto
block checks every result against Python's ``pow``/``divmod``.

``--page-size N`` puts the engine on the paged, prefix-sharing pool
(``--pages`` sizes it, ``--no-prefix-share`` turns admission dedup off) and
adds a ``paging`` block to the report: pages in use, dedup hits,
copy-on-write copies, and under ``--rns-verify`` the per-page fingerprint
counters.

``--mode`` picks the measurement layer (the reference's DESIGN.md §16):

* ``sim`` — the tick-clock replay above;
* ``offline`` — the wall-clock saturation harness (``serve/offline.py``):
  every request available at t=0, length-bucketed single-call prefill
  (``--buckets``), a completion thread overlapping host work with the
  decode steps (``--no-overlap`` for the synchronous baseline),
  ``--replicas`` engines behind one admission queue, TTFT / latency /
  tokens/s in seconds, and the check that the timed run met no argument
  signature that warmup did not;
* ``loadgen`` — the closed-loop QPS search (``serve/loadgen.py``) between
  ``--qps-lo`` and ``--qps-hi`` under the ``--slo-*`` bounds; the report
  carries every phase and the best passing one.

``main`` returns ``(report, engine)`` in ``sim`` and ``(report, harness)``
(the ``OfflineInference``) in the other modes.

The engine serves the dense and moe families.  The archs of the other
families (vlm, ssm, hybrid, encdec), which the engine gates out, fall
back in ``sim`` to ``simulate_single_shot``: one request at a time, a
prefill of the prompt (behind the vlm patches; beside the encdec frames),
then scalar-position decode steps (``"engine": "single-shot"`` in the
report, engine None); ``--rns-verify`` and the crypto lane need the
engine and raise there.

    # whisper-tiny at full width on the card, one request at a time; the
    # ssm families (mamba2, zamba2) take prompts of whole 128-token chunks
    # only, as the reference's prefill does: give them a --trace
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --no-smoke --requests 4 --prompt-mean 64 --max-new 32

``--warm-restart DIR`` (with ``--page-size``, ``--rns-verify`` and prefix
sharing) restores and revalidates the previous run's retained prefix pages
before serving, and persists this run's pool there afterwards, in the
checkpointer's RRNS format (the report's ``warm_restart`` block):

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --page-size 8 --cache-len 64 --prefill-chunk 8 --prompt-mean 10 \
        --rns-verify --warm-restart /tmp/warm        # run it twice

``--profile-start-step/--profile-steps`` capture a ``torch.profiler`` trace
of that window of driver steps (decode ticks in ``sim``, loop iterations
in ``offline``/``loadgen``) into the report's directory (``--profile-dir``
overrides it); the report's ``profile`` block names it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import Counter

import numpy as np
import torch

from ..configs import get_config
from ..models import decode_step, init_params, prefill
from ..serve.batcher import ContinuousBatcher
from ..serve.crypto import CryptoContext, CryptoRequest
from ..serve.offline import OfflineInference, pow2_buckets, sample_stats
from ..serve.scheduler import Request
from .profiling import ProfilerWindow

__all__ = ["main", "simulate", "simulate_single_shot", "synth_requests",
           "synth_crypto_requests", "load_trace", "save_trace"]

FAMILIES = ("llm", "crypto")
_TRIES = 4096   # rejection-sampling tries drawn per block


def _bigint(v) -> int:
    """JSON big ints arrive as ints or as strings ("0x..", "0o..", "123")
    — ``int(s, 0)`` accepts all of them; floats are refused (lossy)."""
    if isinstance(v, bool) or isinstance(v, float):
        raise ValueError(f"big-int field must be an int or string, "
                         f"got {v!r}")
    return int(v, 0) if isinstance(v, str) else int(v)


def load_trace(path: str, rng, vocab: int) -> list:
    """Parse a JSONL workload file into Request/CryptoRequest objects.
    Rids are unique ACROSS families: the engine's verify log is one
    rid-keyed dict shared by both lanes."""
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            family = d.get("family", "llm")
            if family == "crypto":
                reqs.append(CryptoRequest(
                    rid=int(d.get("rid", i)), op=str(d["op"]),
                    a=_bigint(d["a"]), b=_bigint(d["b"]),
                    n=_bigint(d["n"]) if d.get("n") is not None else None,
                    arrival=float(d.get("arrival", 0.0)),
                ))
                continue
            if family != "llm":
                raise ValueError(
                    f"workload file {path} line {i + 1}: unknown family "
                    f"{family!r}; expected one of {FAMILIES}")
            prompt = d.get("prompt")
            if prompt is None:
                plen = int(d["prompt_len"])
                prompt = [int(t) for t in rng.integers(1, vocab, plen)]
            reqs.append(Request(
                rid=int(d.get("rid", i)), prompt=[int(t) for t in prompt],
                max_new=int(d["max_new"]), eos=d.get("eos"),
                arrival=float(d.get("arrival", 0.0)),
            ))
    if not reqs:
        raise ValueError(f"workload file {path} holds no requests")
    counts = Counter(r.rid for r in reqs)
    dups = sorted(r for r, n in counts.items() if n > 1)
    if dups:
        raise ValueError(f"workload file {path}: duplicate rids {dups} "
                         f"(rids are unique across families)")
    return reqs


def synth_requests(n: int, rng, vocab: int, *, prompt_mean: int,
                   max_new: int, arrival_rate: float) -> list:
    """Synthetic workload: Poisson prompt lengths around ``prompt_mean``
    and Poisson arrivals at ``arrival_rate`` requests per decode-step tick
    (rate 0 = everything arrives at t=0).  The same ``numpy`` generator
    state gives the reference's requests."""
    t = 0.0
    reqs = []
    for i in range(n):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        plen = max(1, int(rng.poisson(prompt_mean)))
        reqs.append(Request(
            rid=i, prompt=[int(x) for x in rng.integers(1, vocab, plen)],
            max_new=max_new, arrival=t,
        ))
    return reqs


def synth_crypto_requests(n: int, rng, ctx, *, arrival_rate: float,
                          rid0: int) -> list:
    """Synthetic crypto workload over ``ctx``'s bases: modexp / modmul /
    divmod round-robin, operands drawn uniformly below the relevant bound
    (random odd moduli coprime to both base products — no special forms),
    Poisson arrivals.  The same ``numpy`` generator state gives the
    reference's requests."""
    MMp = ctx.baseB.M * ctx.baseBp.M

    def below(lim: int) -> int:
        # rng.integers tops out at int64; big ints come from raw bytes:
        # rng.bytes(nb) until one is below lim, as the reference draws them.
        # rng.bytes(nb) is ceil(nb/4) little-endian uint32 draws cut to nb
        # bytes, so a block of draws holds the next tries; the generator is
        # then set back and advanced past exactly the tries taken.
        nb = (int(lim).bit_length() + 7) // 8 + 1
        words = (nb - 1) // 4 + 1
        while True:
            state = rng.bit_generator.state
            raw = rng.integers(0, 1 << 32, size=(_TRIES, words),
                               dtype=np.uint32).astype("<u4").tobytes()
            for i in range(_TRIES):
                v = int.from_bytes(raw[4 * words * i : 4 * words * i + nb],
                                   "little")
                if v < lim:
                    rng.bit_generator.state = state
                    rng.integers(0, 1 << 32, size=(i + 1) * words,
                                 dtype=np.uint32)
                    return v

    def modulus() -> int:
        while True:
            N = below(ctx.n_max) | 1
            if N > 4 and math.gcd(N, MMp) == 1:
                return N

    t, reqs = 0.0, []
    for i in range(n):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        op = ("modexp", "modmul", "divmod")[i % 3]
        if op == "divmod":
            a, b, N = below(ctx.baseB.M), 1 + below(ctx.baseB.M - 1), None
        else:
            N = modulus()
            a = below(N)
            b = below(1 << ctx.exp_bits) if op == "modexp" else below(N)
        reqs.append(CryptoRequest(rid=rid0 + i, op=op, a=a, b=b, n=N,
                                  arrival=t))
    return reqs


def save_trace(path: str, reqs: list) -> None:
    with open(path, "w") as f:
        for r in reqs:
            if getattr(r, "family", "llm") == "crypto":
                d = {"rid": r.rid, "family": "crypto", "op": r.op,
                     "a": hex(r.a), "b": hex(r.b), "arrival": r.arrival}
                if r.n is not None:
                    d["n"] = hex(r.n)
            else:
                d = {"rid": r.rid, "prompt": r.prompt,
                     "max_new": r.max_new, "eos": r.eos,
                     "arrival": r.arrival}
            f.write(json.dumps(d) + "\n")


def simulate(engine: ContinuousBatcher, reqs: list, on_step=None) -> dict:
    """Run the arrival/admission/decode loop to completion; returns the
    tick-clock counters (requests stamp their own t_* fields).
    ``on_step`` fires once per decode tick (profiler hook)."""
    reqs = sorted(reqs, key=lambda r: r.arrival)
    t, i, steps, max_conc = 0.0, 0, 0, 0
    while i < len(reqs) or engine.busy:
        while i < len(reqs) and reqs[i].arrival <= t:
            engine.submit(reqs[i])
            i += 1
        engine.try_admit(now=t)
        decoding = engine.sched.decoding_slots()
        laddering = (engine.crypto.running_slots()
                     if engine.crypto is not None else [])
        if decoding or laddering:
            max_conc = max(max_conc, len(decoding) + len(laddering))
            if on_step is not None:
                on_step()
            engine.step(now=t)
            t += 1.0
            steps += 1
        elif i < len(reqs):
            t = math.ceil(reqs[i].arrival)  # idle: fast-forward the clock
    return {"steps": steps, "max_concurrency": max_conc}


def simulate_single_shot(cfg, params, reqs: list, rng, device) -> tuple:
    """Sequential one-request-at-a-time serving for the families the
    continuous batcher gates out (vlm, ssm, hybrid, encdec): a prefill of
    the whole prompt (behind the vlm patches; with the encdec frames; each
    drawn from ``rng`` per request, in the reference's order) into a cache
    of prompt + patches + max_new positions, then scalar-position decode
    steps.  The tick clock counts one tick per generated token.  Returns
    (completed requests, counters) like ``simulate``."""
    n_patches = cfg.n_patches if cfg.family == "vlm" else 0
    t, steps = 0.0, 0
    for r in sorted(reqs, key=lambda q: q.arrival):
        t = max(t, r.arrival)
        r.t_admit = t
        cache_len = len(r.prompt) + r.max_new + n_patches
        batch = {"tokens": torch.tensor([r.prompt], dtype=torch.int32,
                                        device=device)}
        if cfg.family == "vlm":
            batch["patches"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.n_patches, cfg.d_model)).astype(np.float32)).to(
                device)
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(
                device)
        logits, cache = prefill(cfg, params, batch, cache_len)
        tok = int(torch.argmax(logits[0]))
        t += 1.0
        steps += 1
        r.out.append(tok)
        r.t_first = t
        base = len(r.prompt) + n_patches
        i = 0
        while len(r.out) < r.max_new and not (
            r.eos is not None and tok == r.eos
        ):
            lg, cache = decode_step(
                cfg, params, cache,
                torch.tensor([[tok]], dtype=torch.int32, device=device),
                base + i)
            tok = int(torch.argmax(lg[0]))
            r.out.append(tok)
            t += 1.0
            steps += 1
            i += 1
        r.t_done = t
    return sorted(reqs, key=lambda q: q.rid), \
        {"steps": steps, "max_concurrency": 1}


def _crypto_report(crypto_done: list, ctx, *, clock_key: str) -> dict:
    """Crypto block of the report: every result is differentially
    checkable against Python's big ints, so the oracle check runs
    inline; ``clock_key`` names the timebase."""
    ok = 0
    for r in crypto_done:
        want = (divmod(r.a, r.b) if r.op == "divmod"
                else pow(r.a % r.n, r.b, r.n) if r.op == "modexp"
                else (r.a * r.b) % r.n)
        ok += int(r.result == want)
    return {
        "requests": len(crypto_done),
        "ops": dict(Counter(r.op for r in crypto_done)),
        "range_bits": ctx.baseB.M.bit_length(),
        "exp_bits": ctx.exp_bits,
        "oracle_ok": ok,
        "oracle_failed": len(crypto_done) - ok,
        clock_key: sample_stats([r.t_done - r.arrival for r in crypto_done]),
    }


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="continuous-batching serve driver (DESIGN.md §12)")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    help="shrink the arch to the CPU smoke config "
                         "(the default; see --no-smoke)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false",
                    help="run the full published config instead of the "
                         "smoke shrink")
    ap.set_defaults(smoke=True)
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent request capacity (batched cache rows)")
    ap.add_argument("--cache-len", type=int, default=128,
                    help="per-slot KV capacity (prompt + generated)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8,
                    help="synthetic workload size (ignored with --trace)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="replay a JSONL workload file instead")
    ap.add_argument("--families", default=None, metavar="F1,F2",
                    help="keep only these request families of the workload "
                         f"(a subset of {','.join(FAMILIES)}; default all)")
    ap.add_argument("--crypto-slots", type=int, default=0,
                    help="slots of the big-integer crypto lane; 0 disables "
                         "the family")
    ap.add_argument("--crypto-requests", type=int, default=0,
                    help="synthetic crypto requests appended to the "
                         "workload (needs --crypto-slots; ignored with "
                         "--trace)")
    ap.add_argument("--crypto-limbs", type=int, default=8,
                    help="15-bit channels per Montgomery base")
    ap.add_argument("--crypto-exp-bits", type=int, default=32,
                    help="fixed ladder width (max exponent bits)")
    ap.add_argument("--crypto-chunk", type=int, default=8,
                    help="ladder bits per engine tick (divides exp bits)")
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help="Poisson arrivals per decode-step tick (synthetic)")
    ap.add_argument("--prompt-mean", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rns-verify", action="store_true",
                    help="RnsArray cache-integrity fingerprints per slot")
    ap.add_argument("--inject-wire-corrupt", action="store_true",
                    help="with --rns-verify: corrupt one stored wire "
                         "buffer post-run and show detect/repair/re-verify")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the report dict as JSON")
    ap.add_argument("--save-trace", default=None, metavar="PATH",
                    help="write the workload as a replayable JSONL trace")
    ap.add_argument("--device", default="cuda",
                    help="device of the model and the caches (default cuda)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="switch to the paged pool layout with pages of "
                         "this many tokens (DESIGN.md §13)")
    ap.add_argument("--pages", type=int, default=None,
                    help="physical pages in the pool (default: full "
                         "backing for every slot plus the parking page)")
    ap.add_argument("--no-prefix-share", dest="prefix_share",
                    action="store_false",
                    help="disable admission-time prompt-prefix dedup "
                         "(paged mode; measures pure paging)")
    ap.set_defaults(prefix_share=True)
    ap.add_argument("--mode", choices=("sim", "offline", "loadgen"),
                    default="sim",
                    help="sim: deterministic tick-clock replay (default); "
                         "offline: wall-clock saturation harness; loadgen: "
                         "closed-loop max-QPS search (DESIGN.md §16)")
    ap.add_argument("--buckets", default="pow2", metavar="SPEC",
                    help="offline prefill buckets: 'pow2' (power-of-two "
                         "ladder up to cache-len, the default), 'none' "
                         "(chunked prefill), or a comma list like "
                         "'32,64,128'; composes with --page-size (padded "
                         "write barrier through the page table)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel engine replicas behind one shared "
                         "admission queue (offline/loadgen)")
    ap.add_argument("--queue-size", type=int, default=64,
                    help="bound of the completion pump's queue "
                         "(backpressure depth)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="run completion callbacks inline on the driver "
                         "thread — the synchronous baseline the overlap "
                         "ratio is measured against")
    ap.set_defaults(overlap=True)
    ap.add_argument("--qps-lo", type=float, default=0.5,
                    help="loadgen search floor (offered QPS)")
    ap.add_argument("--qps-hi", type=float, default=64.0,
                    help="loadgen search ceiling (offered QPS)")
    ap.add_argument("--qps-iters", type=int, default=4,
                    help="loadgen bisections after the bracket probes")
    ap.add_argument("--phase-requests", type=int, default=16,
                    help="requests per measured loadgen phase")
    ap.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                    help="SLO: TTFT p99 bound (milliseconds)")
    ap.add_argument("--slo-p99-ms", type=float, default=10000.0,
                    help="SLO: end-to-end latency p99 bound (ms)")
    ap.add_argument("--warm-restart", default=None, metavar="DIR",
                    help="warm-restart state dir (needs --page-size and "
                         "--rns-verify): restore + revalidate the previous "
                         "run's retained prefix pages before serving, and "
                         "persist this run's pool state there afterwards")
    ap.add_argument("--profile-start-step", type=int, default=-1,
                    metavar="N",
                    help="driver step at which to start a torch.profiler "
                         "trace (-1 disables; a step is a decode tick in "
                         "sim, a loop iteration in offline/loadgen)")
    ap.add_argument("--profile-steps", type=int, default=0, metavar="N",
                    help="driver steps to capture in the profiler window")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="profiler artifact directory (default: the "
                         "--report directory, else '.')")
    return ap


def _parse_buckets(spec: str, cache_len: int, ap) -> tuple | None:
    if spec == "none":
        return None
    if spec == "pow2":
        return pow2_buckets(cache_len)
    try:
        buckets = tuple(int(b) for b in spec.split(","))
    except ValueError:
        ap.error(f"--buckets takes 'pow2', 'none', or a comma list of "
                 f"ints; got {spec!r}")
    return buckets


def _offline_main(args, ap, cfg, params, reqs, crypto_ctx, rng, window):
    """``--mode offline|loadgen``: the wall-clock saturation harness
    (DESIGN.md §16) instead of the tick-clock replay, ``window`` stepped
    once a loop iteration.  Returns ``(report, harness)``."""
    buckets = _parse_buckets(args.buckets, args.cache_len, ap)
    harness = OfflineInference(
        cfg, params, n_slots=args.slots, cache_len=args.cache_len,
        prefill_chunk=args.prefill_chunk, buckets=buckets,
        replicas=args.replicas, overlap=args.overlap,
        queue_size=args.queue_size, rns_verify=args.rns_verify,
        page_size=args.page_size, n_pages=args.pages,
        prefix_share=args.prefix_share,
        crypto_slots=args.crypto_slots, crypto_ctx=crypto_ctx,
        crypto_chunk=args.crypto_chunk,
    )
    warm = harness.warmup()
    print(f"# warmup: {len(warm['warmed_plens'])} prefill width(s) x "
          f"{warm['replicas']} replica(s) reached: {warm['jit_traces']}")
    harness.on_step = window.step
    report = {
        "arch": cfg.name,
        "mode": args.mode,
        "engine": "offline-harness",
        "device": [str(d) for d in harness.devices],
        "n_slots": args.slots,
        "cache_len": args.cache_len,
        "warmup": warm,
    }
    try:
        if args.mode == "offline":
            for r in reqs:
                r.arrival = 0.0   # offline scenario: all available at t=0
            report.update(harness.run(reqs))
            harness.require_steady_state()
            crypto_done = [r for r, _ in harness.completions
                           if getattr(r, "family", "llm") == "crypto"]
            if crypto_done:
                report["crypto"] = _crypto_report(
                    crypto_done, harness.engines[0].crypto_ctx,
                    clock_key="latency_s")
            if args.rns_verify:
                report["rns"] = {
                    "slots_verified": harness.replica_set.verify_ok,
                    "slots_failed": harness.replica_set.verify_failed,
                }
        else:
            from ..serve.loadgen import SLO, poisson_requests, search_max_qps

            slo = SLO(ttft_p99_s=args.slo_ttft_ms / 1e3,
                      latency_p99_s=args.slo_p99_ms / 1e3)
            rid_counter = [0]

            def make_requests(n, qps):
                rid0 = rid_counter[0]
                rid_counter[0] += n
                return poisson_requests(
                    n, qps, rng, vocab=cfg.vocab,
                    prompt_mean=args.prompt_mean, max_new=args.max_new,
                    cache_len=args.cache_len, rid0=rid0)

            out = search_max_qps(
                harness, make_requests, slo, qps_lo=args.qps_lo,
                qps_hi=args.qps_hi, iters=args.qps_iters,
                phase_requests=args.phase_requests)
            harness.require_steady_state()
            report.update(out)
            print(f"# loadgen: {out['note']}")
    finally:
        window.close()
    if window.enabled:
        report["profile"] = {"artifact": window.artifact,
                             "captured_steps": window.captured}
    print(json.dumps(report, indent=1))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote report to {args.report}")
    return report, harness


def main(argv=None):
    """Run the driver; returns ``(report, engine)``: the dict printed as
    JSON and the engine that served the workload (its ``params``, ``cfg``,
    ``cache`` and completed requests) — in ``--mode offline|loadgen`` the
    ``OfflineInference`` harness instead of the engine."""
    ap = _parser()
    args = ap.parse_args(argv)
    if args.warm_restart and (args.page_size is None or not args.rns_verify
                              or not args.prefix_share):
        ap.error("--warm-restart needs --page-size, --rns-verify, and "
                 "prefix sharing (the persisted state IS the retained "
                 "pages plus their RRNS fingerprints)")
    if args.mode != "sim":
        bad = [f for f, v in (
            ("--warm-restart", bool(args.warm_restart)),
            ("--inject-wire-corrupt", args.inject_wire_corrupt),
        ) if v]
        if bad:
            ap.error(f"--mode {args.mode} drives the wall-clock harness; "
                     f"drop {', '.join(bad)}")
    if args.mode == "loadgen" and (args.trace or args.crypto_requests
                                   or args.crypto_slots):
        ap.error("--mode loadgen synthesizes its own Poisson LLM phases; "
                 "drop --trace / --crypto-*")
    keep = None
    if args.families is not None:
        keep = {f.strip() for f in args.families.split(",") if f.strip()}
        if not keep or keep - set(FAMILIES):
            ap.error(f"--families takes a non-empty subset of "
                     f"{','.join(FAMILIES)}; got {args.families!r}")
    if args.crypto_requests and not args.crypto_slots:
        ap.error("--crypto-requests needs --crypto-slots >= 1")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg.validate()
    rng = np.random.default_rng(args.seed)
    crypto_ctx = (CryptoContext(n_limbs=args.crypto_limbs,
                                exp_bits=args.crypto_exp_bits)
                  if args.crypto_slots else None)
    if args.trace:
        reqs = load_trace(args.trace, rng, cfg.vocab)
    else:
        reqs = synth_requests(
            args.requests, rng, cfg.vocab, prompt_mean=args.prompt_mean,
            max_new=args.max_new, arrival_rate=args.arrival_rate,
        )
        if args.crypto_requests:
            rid0 = 1 + max((r.rid for r in reqs), default=-1)
            reqs += synth_crypto_requests(
                args.crypto_requests, rng, crypto_ctx,
                arrival_rate=args.arrival_rate, rid0=rid0,
            )
    if keep is not None:
        reqs = [r for r in reqs if getattr(r, "family", "llm") in keep]
        if not reqs:
            hint = ("; crypto requests come from --crypto-requests"
                    if "crypto" in keep and not args.crypto_requests else "")
            ap.error(f"--families {args.families} filtered out every "
                     f"request in the workload{hint}")
    if args.save_trace:
        save_trace(args.save_trace, reqs)
    if any(getattr(r, "family", "llm") == "crypto" for r in reqs) \
            and crypto_ctx is None:
        ap.error("the workload holds crypto-family requests; pass "
                 "--crypto-slots >= 1 to arm the crypto lane (or filter "
                 "them out with --families llm)")

    params = init_params(cfg, args.seed, args.device)
    profdir = args.profile_dir or (
        os.path.dirname(os.path.abspath(args.report)) if args.report
        else "."
    )
    window = ProfilerWindow(args.profile_start_step, args.profile_steps,
                            profdir, label=f"serve_{args.mode}",
                            device=args.device)
    if args.mode != "sim":
        return _offline_main(args, ap, cfg, params, reqs, crypto_ctx, rng,
                             window)
    try:
        engine = ContinuousBatcher(
            cfg, params, n_slots=args.slots, cache_len=args.cache_len,
            prefill_chunk=args.prefill_chunk, rns_verify=args.rns_verify,
            page_size=args.page_size, n_pages=args.pages,
            prefix_share=args.prefix_share,
            crypto_slots=args.crypto_slots, crypto_ctx=crypto_ctx,
            crypto_chunk=args.crypto_chunk,
        )
    except NotImplementedError as err:
        if args.rns_verify:
            raise  # the integrity path needs the slot engine
        if crypto_ctx is not None:
            raise  # so does the crypto lane (no single-shot crypto path)
        print(f"# {cfg.name}: {err}")
        print("# falling back to single-shot sequential serving")
        engine = None
    warm = None
    if args.warm_restart and engine is not None:
        try:
            warm = dict(engine.load_warm_state(args.warm_restart),
                        restored=True)
            print(f"# warm restart: adopted {warm['adopted']} of "
                  f"{warm['pages_saved']} persisted page(s), "
                  f"repaired {warm['repaired_pages']}, "
                  f"dropped {warm['dropped']}")
        except FileNotFoundError:
            warm = {"restored": False}  # first run: nothing saved yet
            print(f"# warm restart: no state under {args.warm_restart} "
                  f"yet (cold start)")
    t0 = time.time()
    crypto_done = []
    try:
        if engine is not None:
            counters = simulate(engine, reqs, on_step=window.step)
            done = engine.sched.completed
            if engine.crypto is not None:
                crypto_done = engine.crypto.completed
        else:
            done, counters = simulate_single_shot(cfg, params, reqs, rng,
                                                  args.device)
    finally:
        window.close()
    wall = time.time() - t0

    toks = sum(len(r.out) for r in done)
    report = {
        "arch": cfg.name,
        "engine": "continuous" if engine is not None else "single-shot",
        "device": str(engine.device if engine is not None
                      else params["embed"].device),
        "n_slots": args.slots if engine is not None else 1,
        "cache_len": args.cache_len,
        "requests": len(done) + len(crypto_done),
        "tokens_out": toks,
        "steps": counters["steps"],
        "max_concurrency": counters["max_concurrency"],
        "wall_s": round(wall, 3),
        "tok_per_s": round(toks / wall, 1) if wall > 0 else 0.0,
        "ttft_ticks": sample_stats([r.t_first - r.arrival for r in done]),
        "latency_ticks": sample_stats([r.t_done - r.arrival for r in done]),
    }
    if engine is not None:
        report["jit_traces"] = engine.jit_cache_sizes()
        if engine.paged:
            report["paging"] = engine.page_stats()
    if crypto_done:
        report["crypto"] = _crypto_report(
            crypto_done, engine.crypto_ctx, clock_key="latency_ticks")
    if window.enabled:
        report["profile"] = {"artifact": window.artifact,
                             "captured_steps": window.captured}
    if args.rns_verify:
        # wire keys: one rid per retired LLM request on the batched cache,
        # page ids on the paged pool (only retained shared pages outlive
        # their readers: freed pages were verified at release), and
        # ("crypto", rid) per modexp (one-shots publish none)
        keys = (sorted(k for k in engine.wire.keys()
                       if not isinstance(k, tuple)) if engine.paged
                else [r.rid for r in done])
        keys = keys + [("crypto", r.rid) for r in crypto_done
                       if ("crypto", r.rid) in engine.wire]
        rns = {
            "slots_verified": sum(engine.verify_log.values()),
            "slots_failed": sum(not v for v in engine.verify_log.values()),
            "wire_ok": sum(engine.wire_ok(k) for k in keys),
        }
        if args.inject_wire_corrupt and keys:
            key = keys[0]
            engine.corrupt_wire(key, channel=1, delta=3)
            rns["injected_detected"] = not engine.wire_ok(key)
            rns["injected_repair"] = engine.repair_wire(key)
            rns["injected_reverified"] = engine.wire_ok(key)
        report["rns"] = rns

    if args.warm_restart and engine is not None:
        engine.drain_completed()  # idle the engine before snapshotting
        saved = engine.save_warm_state(args.warm_restart)
        report["warm_restart"] = dict(warm or {}, **saved)
        print(f"# warm restart: persisted {saved['pages_saved']} retained "
              f"page(s) to {args.warm_restart}")

    print(json.dumps(report, indent=1))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote report to {args.report}")
    return report, engine


if __name__ == "__main__":
    main()
