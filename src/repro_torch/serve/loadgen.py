"""Closed-loop load generation for the offline harness (the reference's
DESIGN.md §16), ported from ``repro/serve/loadgen.py`` (which imports no
jax): the same SLO clauses, workload draws and search protocol.

``OfflineInference.run`` measures one workload; this module drives it to
SATURATION: offered load is open-loop (Poisson arrivals at a target QPS —
requests arrive whether or not the system keeps up), admission is
closed-loop (the engine's slots apply backpressure through the shared
admission queue), and ``search_max_qps`` binary-searches the highest
offered rate whose measured phase still meets the SLO.

The SLO combines tail latency (TTFT p99 + end-to-end p99, both in wall
seconds off the request stamps) with a saturation wall check: a phase that
keeps up finishes within its arrival span plus one latency budget of drain
tail; a saturated phase's backlog pushes the wall far past that.  The check
is tail-COMPENSATED (the allowance includes the latency budget) so small
phases are not biased toward failure by their fixed drain tail.
"""
from __future__ import annotations

import dataclasses

from .scheduler import Request

__all__ = ["SLO", "phase_stats", "poisson_requests", "search_max_qps"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Pass/fail contract one measured phase is held to."""

    ttft_p99_s: float = 2.0
    latency_p99_s: float = 10.0
    # fraction of the ideal completion rate the phase must sustain: the
    # measured wall may not exceed (arrival span + one latency budget) /
    # this ratio — backlog growth, not per-request latency, is the
    # first symptom of overload and it lands squarely on the wall
    min_sustained_ratio: float = 0.95

    def check(self, phase: dict) -> list[str]:
        """Empty list = pass; otherwise the failed clauses."""
        fails = []
        if phase["ttft_s"]["p99"] > self.ttft_p99_s:
            fails.append(
                f"ttft_p99 {phase['ttft_s']['p99']:.4f}s > "
                f"{self.ttft_p99_s}s"
            )
        if phase["latency_s"]["p99"] > self.latency_p99_s:
            fails.append(
                f"latency_p99 {phase['latency_s']['p99']:.4f}s > "
                f"{self.latency_p99_s}s"
            )
        allowed = (phase["arrival_span_s"] + self.latency_p99_s) \
            / self.min_sustained_ratio
        if phase["wall_s"] > allowed:
            fails.append(
                f"saturated: wall {phase['wall_s']:.3f}s > allowed "
                f"{allowed:.3f}s (arrival span "
                f"{phase['arrival_span_s']:.3f}s + latency budget, "
                f"/{self.min_sustained_ratio})"
            )
        return fails


def poisson_requests(n: int, qps: float, rng, *, vocab: int,
                     prompt_mean: float, max_new: int, cache_len: int,
                     rid0: int = 0) -> list[Request]:
    """Open-loop LLM phase workload: ``n`` requests with exponential
    inter-arrival gaps at ``qps`` (arrival offsets in SECONDS — the
    harness replays them on the wall clock) and geometric prompt
    lengths clipped to fit ``cache_len``."""
    if qps <= 0:
        raise ValueError("qps must be > 0")
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / qps))
        plen = 1 + min(int(rng.geometric(1.0 / max(prompt_mean, 1.0))),
                       cache_len - max_new - 1)
        prompt = [int(x) for x in rng.integers(1, vocab, size=plen)]
        reqs.append(Request(rid=rid0 + i, prompt=prompt, max_new=max_new,
                            eos=-1, arrival=t))
    return reqs


def phase_stats(report: dict, offered_qps: float) -> dict:
    """One phase's record for the search transcript: the harness report
    reduced to the SLO-relevant figures plus the offered/sustained
    pair.  Sustained QPS counts COMPLETED requests over the full wall
    (arrival span + drain tail) — a backlogged phase keeps paying its
    tail, which is exactly what blows the SLO's wall allowance."""
    wall = report["wall_s"]
    return {
        "offered_qps": offered_qps,
        "sustained_qps": report["requests"] / wall if wall > 0 else 0.0,
        "requests": report["requests"],
        "wall_s": wall,
        "arrival_span_s": report["arrival_span_s"],
        "tok_per_s": report["tok_per_s"],
        "ttft_s": report["ttft_s"],
        "latency_s": report["latency_s"],
        "retrace_free": report["retrace_free"],
    }


def search_max_qps(harness, make_requests, slo: SLO, *, qps_lo: float,
                   qps_hi: float, iters: int = 5,
                   phase_requests: int = 32) -> dict:
    """Binary-search the max sustainable offered QPS under ``slo``.

    ``make_requests(n, qps)`` must synthesize a FRESH phase workload
    (new rids) with Poisson arrivals at ``qps``; ``harness`` is a
    warmed ``OfflineInference``.  Over ranks every rank calls this with
    the same seeded ``make_requests``: each phase's record is rank 0's,
    broadcast (``harness.from_root``), so every rank takes the same
    bisection path and returns the same transcript.  Protocol: measure
    ``qps_lo`` (fail ->
    report unsustainable floor), measure ``qps_hi`` (pass -> the
    bracket never saturated; report the ceiling), then ``iters``
    geometric bisections of the (pass, fail) bracket.  Returns the full
    phase transcript plus an attestation of the best PASSING phase —
    the sustained-QPS figure is a measurement, never an interpolation.
    """
    if not 0 < qps_lo < qps_hi:
        raise ValueError("need 0 < qps_lo < qps_hi")
    if iters < 0:
        raise ValueError("iters must be >= 0")
    phases: list[dict] = []
    from_root = getattr(harness, "from_root", lambda ph: ph)

    def trial(qps: float) -> dict:
        reqs = make_requests(phase_requests, qps)
        report = harness.run(reqs)   # None on a rank other than 0
        ph = from_root(None if report is None else phase_stats(report, qps))
        fails = slo.check(ph)
        ph["slo_pass"], ph["slo_fails"] = not fails, fails
        phases.append(ph)
        return ph

    def attest(ph: dict | None, note: str) -> dict:
        out = {
            "slo": dataclasses.asdict(slo),
            "phases": phases,
            "bracket": [qps_lo, qps_hi],
            "note": note,
        }
        if ph is None:
            out["slo_pass"] = False
            out["max_qps"] = 0.0
            out["sustained_qps"] = 0.0
            return out
        out["slo_pass"] = True
        out["max_qps"] = ph["offered_qps"]
        out["sustained_qps"] = ph["sustained_qps"]
        out["attestation"] = {
            "slo_pass": True,
            "offered_qps": ph["offered_qps"],
            "sustained_qps": ph["sustained_qps"],
            "ttft_p99_s": ph["ttft_s"]["p99"],
            "latency_p99_s": ph["latency_s"]["p99"],
            "retrace_free": ph["retrace_free"],
        }
        return out

    lo_ph = trial(qps_lo)
    if not lo_ph["slo_pass"]:
        return attest(None, f"floor qps_lo={qps_lo} already violates the "
                            f"SLO: {lo_ph['slo_fails']}")
    hi_ph = trial(qps_hi)
    if hi_ph["slo_pass"]:
        return attest(hi_ph, f"ceiling qps_hi={qps_hi} still meets the "
                             f"SLO; raise the bracket to find the knee")
    lo, hi, best = qps_lo, qps_hi, lo_ph
    for _ in range(iters):
        mid = (lo * hi) ** 0.5  # geometric: brackets often span decades
        ph = trial(mid)
        if ph["slo_pass"]:
            lo, best = mid, ph
        else:
            hi = mid
    return attest(best, f"converged bracket [{lo:.3f}, {hi:.3f}] qps "
                        f"after {iters} bisections")
