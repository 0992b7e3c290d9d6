"""Serve CLI, crypto family: a synthetic big-integer workload through the
crypto lane (``serve.batcher.CryptoEngine``) on the deterministic tick clock
of the reference's ``--mode sim``, with every result checked against
Python's big ints.

    PYTHONPATH=src python -m repro_torch.launch.serve --families crypto \\
        --crypto-slots 4 --crypto-requests 8 --crypto-limbs 8 \\
        --crypto-exp-bits 32 --rns-verify --inject-wire-corrupt \\
        [--device cpu]

The flags are the reference's (``src/repro/launch/serve.py``).  Until the
serve slice ports the LLM lane, ``crypto`` is the only family: ``--families
llm`` exits with an error.  The report (printed as JSON) carries the lane's
tick counters, the ``crypto`` block — ``oracle_ok``/``oracle_failed``
against ``pow``/``divmod``, latency in ticks — and, with ``--rns-verify``,
the fingerprint verify and wire repair counters.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from collections import Counter

import numpy as np

from ..serve.batcher import CryptoEngine
from ..serve.crypto import CryptoContext, CryptoRequest

__all__ = ["main", "simulate", "synth_crypto_requests"]

FAMILIES = ("llm", "crypto")
_TRIES = 4096   # rejection-sampling tries drawn per block


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


def _stats(xs: list) -> dict:
    """n/mean/p50/p95/p99 of a sample; an empty sample gives ``n: 0``."""
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {"n": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99))}


def simulate(engine: CryptoEngine, reqs: list) -> dict:
    """Run the arrival/admission/ladder loop to completion on the tick
    clock; returns the counters (requests stamp their own t_* fields)."""
    reqs = sorted(reqs, key=lambda r: r.arrival)
    t, i, steps, max_conc = 0.0, 0, 0, 0
    while i < len(reqs) or engine.busy:
        while i < len(reqs) and reqs[i].arrival <= t:
            engine.submit(reqs[i])
            i += 1
        engine.try_admit(now=t)
        laddering = engine.crypto.running_slots()
        if laddering:
            max_conc = max(max_conc, len(laddering))
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", default="crypto", metavar="F1,F2",
                    help="request families to serve; 'crypto' until the "
                         "serve slice ports the LLM lane")
    ap.add_argument("--crypto-slots", type=int, default=0,
                    help="slots of the big-integer crypto lane")
    ap.add_argument("--crypto-requests", type=int, default=0,
                    help="synthetic crypto requests in the workload")
    ap.add_argument("--crypto-limbs", type=int, default=8,
                    help="15-bit channels per Montgomery base")
    ap.add_argument("--crypto-exp-bits", type=int, default=32,
                    help="fixed ladder width (max exponent bits)")
    ap.add_argument("--crypto-chunk", type=int, default=8,
                    help="ladder bits per engine tick (divides exp bits)")
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help="Poisson arrivals per tick (synthetic)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rns-verify", action="store_true",
                    help="per-slot RRNS fingerprints, verified at retirement")
    ap.add_argument("--inject-wire-corrupt", action="store_true",
                    help="with --rns-verify: corrupt one stored wire "
                         "buffer post-run and show detect/repair/re-verify")
    ap.add_argument("--device", default="cuda",
                    help="device of the lane's state (default cuda)")
    args = ap.parse_args(argv)

    keep = {f.strip() for f in args.families.split(",") if f.strip()}
    if not keep or keep - set(FAMILIES):
        ap.error(f"--families takes a non-empty subset of "
                 f"{','.join(FAMILIES)}; got {args.families!r}")
    if "llm" in keep:
        ap.error("the llm family comes with the serve slice (models and the "
                 "ContinuousBatcher are not ported yet); use --families "
                 "crypto")
    if args.crypto_slots < 1:
        ap.error("the crypto lane needs --crypto-slots >= 1")
    if args.crypto_requests < 1:
        ap.error("nothing to serve: pass --crypto-requests >= 1")

    rng = np.random.default_rng(args.seed)
    ctx = CryptoContext(n_limbs=args.crypto_limbs,
                        exp_bits=args.crypto_exp_bits)
    reqs = synth_crypto_requests(args.crypto_requests, rng, ctx,
                                 arrival_rate=args.arrival_rate, rid0=0)
    engine = CryptoEngine(crypto_slots=args.crypto_slots, crypto_ctx=ctx,
                          crypto_chunk=args.crypto_chunk,
                          rns_verify=args.rns_verify, device=args.device)
    t0 = time.time()
    counters = simulate(engine, reqs)
    wall = time.time() - t0
    done = engine.crypto.completed
    report = {
        "engine": "crypto",
        "device": str(engine.device),
        "n_slots": args.crypto_slots,
        "requests": len(done),
        "steps": counters["steps"],
        "max_concurrency": counters["max_concurrency"],
        "wall_s": round(wall, 3),
        "crypto": _crypto_report(done, ctx, clock_key="latency_ticks"),
    }
    if args.rns_verify:
        # modexps publish ("crypto", rid) keys; one-shots publish none
        keys = [("crypto", r.rid) for r in done
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
    return report


if __name__ == "__main__":
    main()
