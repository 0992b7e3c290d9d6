"""Continuous-batching serve driver (the reference's DESIGN.md §12), in
its ``--mode sim``: ``serve.batcher.ContinuousBatcher`` over a request
workload, synthetic (``--requests N`` with Poisson arrivals) or replayed
from a workload file (``--trace FILE``), on a deterministic clock of
decode-step ticks (one batched decode step a tick), so every latency number
is the same for a given seed; wall-clock throughput is reported beside it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \
        --requests 8 --slots 4 --arrival-rate 0.5 [--device cpu]

    # gemma3-1b at full width on the card, RRNS fingerprints verified
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --no-smoke --slots 8 --cache-len 2048 --prefill-chunk 256 \
        --requests 16 --prompt-mean 1024 --max-new 64 --arrival-rate 0.5 \
        --rns-verify --inject-wire-corrupt

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

Not ported yet, each refused with the ROADMAP item it waits for:
``--mode offline|loadgen`` and their flags, the paged pool
(``--page-size``, ``--pages``, ``--no-prefix-share``), ``--warm-restart``,
the profiler window (``--profile-*``), and the families other than dense.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from collections import Counter

import numpy as np

from ..configs import get_config
from ..models import init_params
from ..serve.batcher import ContinuousBatcher
from ..serve.crypto import CryptoContext, CryptoRequest
from ..serve.scheduler import Request

__all__ = ["main", "simulate", "synth_requests", "synth_crypto_requests",
           "load_trace", "save_trace"]

FAMILIES = ("llm", "crypto")
_TRIES = 4096   # rejection-sampling tries drawn per block
_ROADMAP = "ROADMAP.md, queue 1"


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


def _stats(xs: list) -> dict:
    """n/mean/p50/p95/p99 of a sample; an empty sample (a family filter
    can leave zero completions) gives the explicit ``n: 0`` record."""
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def simulate(engine: ContinuousBatcher, reqs: list) -> dict:
    """Run the arrival/admission/decode loop to completion; returns the
    tick-clock counters (requests stamp their own t_* fields)."""
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
            engine.step(now=t)
            t += 1.0
            steps += 1
        elif i < len(reqs):
            t = math.ceil(reqs[i].arrival)  # idle: fast-forward the clock
    return {"steps": steps, "max_concurrency": max_conc}


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
        clock_key: _stats([r.t_done - r.arrival for r in crypto_done]),
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
    # the reference's flags for what is not ported yet: each refused, with
    # the ROADMAP item it waits for
    later = ap.add_argument_group("not ported yet (refused)")
    later.add_argument("--mode", choices=("sim", "offline", "loadgen"),
                       default="sim")
    later.add_argument("--page-size", type=int, default=None)
    later.add_argument("--pages", type=int, default=None)
    later.add_argument("--no-prefix-share", dest="prefix_share",
                       action="store_false", default=True)
    later.add_argument("--buckets", default=None, metavar="SPEC")
    later.add_argument("--replicas", type=int, default=1)
    later.add_argument("--queue-size", type=int, default=64)
    later.add_argument("--no-overlap", dest="overlap", action="store_false",
                       default=True)
    for flag, default in (("--qps-lo", 0.5), ("--qps-hi", 64.0),
                          ("--slo-ttft-ms", 2000.0), ("--slo-p99-ms", 1e4)):
        later.add_argument(flag, type=float, default=default)
    later.add_argument("--qps-iters", type=int, default=4)
    later.add_argument("--phase-requests", type=int, default=16)
    later.add_argument("--warm-restart", default=None, metavar="DIR")
    later.add_argument("--profile-start-step", type=int, default=-1)
    later.add_argument("--profile-steps", type=int, default=0)
    later.add_argument("--profile-dir", default=None)
    return ap


# flag -> (argparse dest, what it waits for)
_PAGED = "the paged pool of a later serve slice"
_OFFLINE = "the offline harness and load generator of a later serve slice"
_UNPORTED = {
    "--page-size": ("page_size", _PAGED),
    "--pages": ("pages", _PAGED),
    "--no-prefix-share": ("prefix_share", _PAGED),
    "--buckets": ("buckets", _OFFLINE),
    "--replicas": ("replicas", _OFFLINE),
    "--queue-size": ("queue_size", _OFFLINE),
    "--no-overlap": ("overlap", _OFFLINE),
    "--qps-lo": ("qps_lo", _OFFLINE),
    "--qps-hi": ("qps_hi", _OFFLINE),
    "--qps-iters": ("qps_iters", _OFFLINE),
    "--phase-requests": ("phase_requests", _OFFLINE),
    "--slo-ttft-ms": ("slo_ttft_ms", _OFFLINE),
    "--slo-p99-ms": ("slo_p99_ms", _OFFLINE),
    "--warm-restart": ("warm_restart",
                       "warm restart, with the checkpointer"),
    "--profile-start-step": ("profile_start_step", "the profiler window"),
    "--profile-steps": ("profile_steps", "the profiler window"),
    "--profile-dir": ("profile_dir", "the profiler window"),
}


def _refuse_unported(ap, args) -> None:
    if args.mode != "sim":
        ap.error(f"--mode {args.mode} waits for {_OFFLINE} ({_ROADMAP}); "
                 f"the port runs --mode sim")
    for flag, (dest, what) in _UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            ap.error(f"{flag} waits for {what} ({_ROADMAP})")


def main(argv=None):
    """Run the driver; returns ``(report, engine)``: the dict printed as
    JSON and the engine that served the workload (its ``params``, ``cfg``,
    ``cache`` and completed requests)."""
    ap = _parser()
    args = ap.parse_args(argv)
    _refuse_unported(ap, args)
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
    if cfg.family != "dense":
        ap.error(f"{cfg.name} is of the {cfg.family!r} family; the "
                 f"single-shot fallback and the other families wait for "
                 f"their slices ({_ROADMAP}); the port serves dense archs")
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
    engine = ContinuousBatcher(
        cfg, params, n_slots=args.slots, cache_len=args.cache_len,
        prefill_chunk=args.prefill_chunk, rns_verify=args.rns_verify,
        crypto_slots=args.crypto_slots, crypto_ctx=crypto_ctx,
        crypto_chunk=args.crypto_chunk,
    )
    t0 = time.time()
    counters = simulate(engine, reqs)
    wall = time.time() - t0
    done = engine.sched.completed
    crypto_done = engine.crypto.completed if engine.crypto is not None else []

    toks = sum(len(r.out) for r in done)
    report = {
        "arch": cfg.name,
        "engine": "continuous",
        "device": str(engine.device),
        "n_slots": args.slots,
        "cache_len": args.cache_len,
        "requests": len(done) + len(crypto_done),
        "tokens_out": toks,
        "steps": counters["steps"],
        "max_concurrency": counters["max_concurrency"],
        "wall_s": round(wall, 3),
        "tok_per_s": round(toks / wall, 1) if wall > 0 else 0.0,
        "ttft_ticks": _stats([r.t_first - r.arrival for r in done]),
        "latency_ticks": _stats([r.t_done - r.arrival for r in done]),
        "jit_traces": engine.jit_cache_sizes(),
    }
    if crypto_done:
        report["crypto"] = _crypto_report(
            crypto_done, engine.crypto_ctx, clock_key="latency_ticks")
    if args.rns_verify:
        # wire keys: one rid per retired LLM request, and ("crypto", rid)
        # per modexp (one-shots publish none)
        keys = [r.rid for r in done] + [
            ("crypto", r.rid) for r in crypto_done
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

    print(json.dumps(report, indent=1))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote report to {args.report}")
    return report, engine


if __name__ == "__main__":
    main()
