"""The port's offline harness and load generator (``repro_torch.serve.offline``,
``repro_torch.serve.loadgen``, ``launch.serve --mode offline|loadgen``)
against the reference's.

Tolerances: workloads drawn from one seed, the QPS search's transcript on a
modelled stub harness, the SLO verdicts, ``pow2_buckets``, ``sample_stats``
and the harness's counts: equal.  Wall-clock numbers (TTFT, latency,
tokens/s) are checked for shape and sign only: they are this host's.

The completion pump runs a thread, and tier-1 runs no per-test timeout, so
every wait on it here is bounded (``within``): a hang fails the test within
seconds instead of holding the run.
"""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from conftest import CACHE_LEN, CHUNK
from repro.serve import loadgen as RL
from repro.serve import offline as RO
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import loadgen as TL
from repro_torch.serve import offline as TO
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.crypto import CryptoContext
from repro_torch.serve.scheduler import Request

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (8, 16, 32)
WAIT = 10.0   # seconds: the bound on every wait on the pump's thread


def within(fn, *args, seconds=WAIT):
    """Run ``fn(*args)`` on a helper thread, joined with a timeout; return
    its result or re-raise its exception.  A call that does not return in
    time fails the test."""
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:   # handed back to the test's thread
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn} did not return within {seconds} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


@pytest.fixture(scope="module")
def model():
    cfg = get_config("gemma-2b").smoke()
    return cfg, init_params(cfg, 0, "cpu")


def requests(vocab, seed=0, n=4):
    """The reference's ``test_serve_offline.py::_requests``: lengths
    straddle the buckets."""
    rng = np.random.default_rng(seed)
    plens = [5, 11, 3, 17, 23, 7][:n]
    return [Request(rid=i, prompt=[int(t) for t in rng.integers(1, vocab, p)],
                    max_new=6, eos=-1) for i, p in enumerate(plens)]


# ------------------------------------------------------------------ pump
def test_pump_preserves_order_under_slow_callback():
    def slow(x):
        time.sleep(0.002)
        return x * 10

    pump = TO.CompletionPump(slow, queue_size=4)
    for i in range(16):
        within(pump.put, i)
    within(pump.flush)
    within(pump.close)
    assert pump.completed == [(i, i * 10) for i in range(16)]
    assert pump.stats()["processed"] == 16


def test_pump_bounded_queue_backpressure():
    gate = threading.Event()

    def gated(x):
        gate.wait(WAIT)
        return x

    pump = TO.CompletionPump(gated, queue_size=2)
    within(pump.put, 0)        # the worker takes it and waits on the gate
    time.sleep(0.05)
    within(pump.put, 1)
    within(pump.put, 2)        # the queue is now full
    t = threading.Thread(target=pump.put, args=(3,), daemon=True)
    t.start()
    t.join(0.1)
    assert t.is_alive()        # the producer is held by the bound
    gate.set()
    t.join(WAIT)
    assert not t.is_alive()
    within(pump.flush)
    within(pump.close)
    st = pump.stats()
    assert st["processed"] == 4 and st["blocked_puts"] >= 1
    assert st["max_depth"] <= 2


def test_pump_first_error_wins_and_drains():
    gate = threading.Event()

    def boom(x):
        if x == 0:
            gate.wait(WAIT)
            raise ValueError("detokenize failed on 0")
        if x == 1:
            raise KeyError("a second failure never surfaces")
        return x

    pump = TO.CompletionPump(boom, queue_size=2)
    within(pump.put, 0)
    time.sleep(0.05)
    within(pump.put, 1)
    within(pump.put, 2)
    gate.set()
    with pytest.raises(ValueError, match="failed on 0"):
        within(pump.flush)
    within(pump.close)         # the error was consumed: close is clean
    within(pump.close)         # and idempotent
    assert pump.completed == []
    assert pump.stats()["dropped"] == 2


def test_pump_error_surfaces_from_put_without_hanging():
    def boom(x):
        if x == 2:
            raise ValueError("detokenize failed on 2")
        return x

    pump = TO.CompletionPump(boom, queue_size=2)

    def produce():
        for i in range(64):
            pump.put(i)
        pump.flush()

    with pytest.raises(ValueError, match="failed on 2"):
        within(produce)
    within(pump.close)
    done = [x for x, _ in pump.completed]
    assert 2 not in done and done[:2] == [0, 1]


def test_pump_put_after_close_refused():
    pump = TO.CompletionPump(lambda x: x)
    within(pump.close)
    with pytest.raises(RuntimeError, match="closed"):
        within(pump.put, 0)


def test_default_callback_sees_host_data(model):
    """A retired request reaches the callback with its tokens as ints."""
    cfg, params = model
    eng = ContinuousBatcher(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                            prefill_chunk=CHUNK)
    eng.submit(Request(rid=0, prompt=[3, 1, 4], max_new=3))
    req = eng.run_to_completion()[0]
    assert all(type(t) is int for t in req.out)
    assert TO.default_callback(req) == " ".join(map(str, req.out))


# ------------------------------------------------------- small functions
def test_pow2_buckets_and_sample_stats_match_reference():
    for n in (1, 8, 32, 48, 128, 2048):
        assert TO.pow2_buckets(n) == RO.pow2_buckets(n)
    assert TO.pow2_buckets(48, lo=16) == RO.pow2_buckets(48, lo=16)
    with pytest.raises(ValueError):
        TO.pow2_buckets(0)
    for xs in ([], [1.0], [3.0, 1.0, 2.0, 10.0]):
        assert TO.sample_stats(xs) == RO.sample_stats(xs)


def test_replica_devices():
    cpu = torch.device("cpu")
    assert TO.replica_devices(1, [cpu]) == [cpu]
    assert TO.replica_devices(3, [cpu]) == [cpu] * 3
    cards = [f"cuda:{i}" for i in range(4)]
    assert TO.replica_devices(4, cards) == [torch.device(c) for c in cards]
    assert TO.replica_devices(2, cards) == [torch.device("cuda:0"),
                                            torch.device("cuda:1")]
    # three replicas do not divide four cards: every replica on the first
    assert TO.replica_devices(3, cards) == [torch.device("cuda:0")] * 3
    with pytest.raises(ValueError):
        TO.replica_devices(0, [cpu])


def test_replica_devices_raise_without_a_card(monkeypatch):
    """No card and no devices named: an error, not a quiet fall back to
    the CPU; named, the CPU serves."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TO.replica_devices(2)
    assert TO.replica_devices(2, ["cpu"]) == [torch.device("cpu")] * 2


def test_profiler_window_takes_its_device():
    """``ProfilerWindow`` has no default device: each caller names one."""
    from repro_torch.launch.profiling import ProfilerWindow

    with pytest.raises(TypeError):
        ProfilerWindow(0, 1, ".")
    w = ProfilerWindow(-1, 0, ".", device="cpu")
    assert not w.enabled
    assert ProfilerWindow(0, 1, ".", device="cuda").activities[-1] == \
        torch.profiler.ProfilerActivity.CUDA


# ---------------------------------------------------------- replica set
def test_replica_set_shared_queue_least_loaded(model):
    cfg, params = model
    engines = [ContinuousBatcher(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                                 prefill_chunk=CHUNK) for _ in range(2)]
    rs = TO.ReplicaSet(engines)
    for r in requests(cfg.vocab, seed=5, n=6):
        rs.submit(r)
    assert rs.pump(0.0) == 4
    assert rs.dispatched == [2, 2] and len(rs.queue) == 2
    done, t = [], 0.0
    while rs.busy:
        rs.pump(t)
        done.extend(rs.step_all(t))
        t += 1.0
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4, 5]
    assert sum(rs.dispatched) == 6 and min(rs.dispatched) >= 2


def test_replica_set_routes_crypto_one_shots_round_robin(model):
    from repro_torch.serve.crypto import CryptoRequest

    cfg, params = model
    ctx = CryptoContext(n_limbs=3, exp_bits=8)
    engines = [ContinuousBatcher(cfg, params, n_slots=1, cache_len=CACHE_LEN,
                                 prefill_chunk=CHUNK, crypto_slots=1,
                                 crypto_ctx=ctx) for _ in range(2)]
    rs = TO.ReplicaSet(engines)
    for i in range(4):
        rs.submit(CryptoRequest(rid=i, op="modmul", a=7 + i, b=200,
                                n=1000003))
    assert rs.pump(0.0) == 4 and rs.dispatched == [2, 2]
    done = []
    while rs.busy:
        done.extend(rs.step_all(0.0))
    assert sorted((r.rid, r.result) for r in done) == [
        (i, (7 + i) * 200 % 1000003) for i in range(4)]
    with pytest.raises(ValueError, match="crypto lane"):
        TO.ReplicaSet([ContinuousBatcher(
            cfg, params, n_slots=1, cache_len=CACHE_LEN,
            prefill_chunk=CHUNK)])._pick("crypto", CryptoRequest(
                rid=9, op="modmul", a=1, b=2, n=1000003))


# ------------------------------------------------------ offline harness
@pytest.mark.parametrize("page_size", [None, 8])
def test_two_replica_harness_is_retrace_free(model, page_size):
    """Warmup, then a timed run with two replicas on the CPU: every
    request served once, both replicas used, the census unchanged since
    warmup (each bucket width, the copy and the fingerprint reached there),
    and the tokens those of one engine serving the requests in turn."""
    cfg, params = model
    h = TO.OfflineInference(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                            prefill_chunk=4, buckets=BUCKETS, replicas=2,
                            queue_size=8, rns_verify=True,
                            page_size=page_size)
    assert h.devices == [torch.device("cpu")] * 2 and h.n_chips == 1
    warm = h.warmup()
    census = warm["jit_traces"][0]
    assert census["extend"] == len(BUCKETS) and census["decode"] == 1
    assert census["fingerprint"] == 1
    if page_size:
        assert census["copy"] == 1
    reqs = requests(cfg.vocab, seed=7, n=6)
    rep = within(h.run, reqs, seconds=120)
    h.require_steady_state()
    assert h.steady_state_ok() and rep["retrace_free"]
    assert rep["requests"] == 6 and rep["tokens_out"] == 36
    assert sum(rep["dispatched"]) == 6 and min(rep["dispatched"]) >= 1
    assert rep["ttft_s"]["n"] == 6
    assert rep["latency_s"]["p99"] >= rep["ttft_s"]["p50"] >= 0
    assert rep["overlap"]["processed"] == 6 and rep["n_chips"] == 1
    assert rep["buckets"]["fallbacks"] == 0
    assert sum(rep["buckets"]["hits"].values()) == 6
    assert h.replica_set.verify_failed == 0
    assert h.replica_set.verify_ok == 6   # warmup's requests not counted
    if page_size:
        assert len(rep["paging"]) == 2
    solo = ContinuousBatcher(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                             prefill_chunk=CHUNK)
    for r in requests(cfg.vocab, seed=7, n=6):
        solo.submit(r)
    want = {r.rid: r.out for r in solo.run_to_completion()}
    assert {r.rid: r.out for r, _ in h.completions} == want


def test_run_before_warmup_refused(model):
    cfg, params = model
    h = TO.OfflineInference(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                            buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="warmup"):
        h.run(requests(cfg.vocab, n=1))
    with pytest.raises(RuntimeError, match="warmup"):
        h.require_steady_state()


def test_steady_state_catches_a_new_signature(model):
    """A timed run that meets a signature warmup did not reach fails the
    check (bucket 8 warmed, then a longer prompt through the chunk loop of
    width 4)."""
    cfg, params = model
    h = TO.OfflineInference(cfg, params, n_slots=2, cache_len=CACHE_LEN,
                            prefill_chunk=4, buckets=(8,), overlap=False)
    h.warmup()
    rep = within(h.run, [Request(rid=0, prompt=[5] * 20, max_new=2)],
                 seconds=120)
    assert not rep["retrace_free"] and rep["overlap"] == {"enabled": False}
    with pytest.raises(RuntimeError, match="retraced"):
        h.require_steady_state()


# -------------------------------------------------------- load generator
def test_poisson_requests_match_reference():
    kw = dict(vocab=100, prompt_mean=8, max_new=8, cache_len=32, rid0=500)
    got = TL.poisson_requests(32, 4.0, np.random.default_rng(0), **kw)
    want = RL.poisson_requests(32, 4.0, np.random.default_rng(0), **kw)
    key = lambda r: (r.rid, r.prompt, r.max_new, r.eos, r.arrival)
    assert [key(r) for r in got] == [key(r) for r in want]
    assert [r.rid for r in got] == list(range(500, 532))
    with pytest.raises(ValueError):
        TL.poisson_requests(1, 0.0, np.random.default_rng(0), **kw)


def test_slo_clauses_match_reference():
    def phase(ttft=0.1, lat=0.5, wall=10.0, span=9.0):
        return {"ttft_s": {"p99": ttft}, "latency_s": {"p99": lat},
                "wall_s": wall, "arrival_span_s": span}

    kw = dict(ttft_p99_s=0.2, latency_p99_s=1.0, min_sustained_ratio=0.95)
    allowed = (9.0 + 1.0) / 0.95
    for ph in (phase(), phase(ttft=0.3), phase(lat=1.5),
               phase(wall=allowed + 0.1), phase(wall=allowed - 0.1),
               phase(wall=0.9, span=0.1), phase(ttft=9, lat=9, wall=99)):
        assert TL.SLO(**kw).check(ph) == RL.SLO(**kw).check(ph)
    assert TL.SLO(**kw).check(phase()) == []


class ModelHarness:
    """The reference's queueing stub (``test_serve_loadgen.py``) with
    capacity C requests/s; duck-types ``OfflineInference.run``."""

    def __init__(self, capacity_qps):
        self.c = capacity_qps

    def run(self, reqs):
        n = len(reqs)
        span = max(r.arrival for r in reqs)
        service = n / self.c
        wall = max(span, service) + 1.0 / self.c
        backlog = max(0.0, service - span)
        ttft, lat = 0.01 + backlog / n, 0.05 + backlog
        stats = lambda v: {"n": n, "mean": v, "p50": v, "p95": v, "p99": v}
        return {"requests": n, "wall_s": wall, "arrival_span_s": span,
                "tok_per_s": n * 8 / wall, "ttft_s": stats(ttft),
                "latency_s": stats(lat), "retrace_free": True}


@pytest.mark.parametrize("capacity,lo,hi,iters", [
    (10.0, 1.0, 100.0, 6),    # converges on the knee
    (0.05, 1.0, 10.0, 3),     # the floor already fails
    (1e6, 1.0, 10.0, 3),      # the ceiling still passes
])
def test_search_max_qps_transcript_matches_reference(capacity, lo, hi,
                                                     iters):
    """The whole transcript on the modelled stub — every phase, the
    bracket, the note and the attestation — equal in both packages."""
    out = []
    for mod in (TL, RL):
        rng = np.random.default_rng(7)
        mk = lambda n, qps: mod.poisson_requests(
            n, qps, rng, vocab=100, prompt_mean=8, max_new=8, cache_len=32)
        slo = mod.SLO(ttft_p99_s=0.5, latency_p99_s=1.0)
        out.append(mod.search_max_qps(ModelHarness(capacity), mk, slo,
                                      qps_lo=lo, qps_hi=hi, iters=iters,
                                      phase_requests=64))
    assert out[0] == out[1]
    assert len(out[0]["phases"]) == (2 + iters if capacity == 10.0 else
                                     1 if capacity < 1 else 2)
    with pytest.raises(ValueError):
        TL.search_max_qps(ModelHarness(1.0), None, TL.SLO(), qps_lo=5.0,
                          qps_hi=5.0)
    with pytest.raises(ValueError):
        TL.search_max_qps(ModelHarness(1.0), None, TL.SLO(), qps_lo=1.0,
                          qps_hi=2.0, iters=-1)


def test_real_phase_meets_generous_slo(model):
    cfg, params = model
    h = TO.OfflineInference(cfg, params, n_slots=4, cache_len=CACHE_LEN,
                            prefill_chunk=CHUNK, buckets=BUCKETS,
                            queue_size=8, page_size=8)
    h.warmup()
    reqs = TL.poisson_requests(8, 50.0, np.random.default_rng(11),
                               vocab=cfg.vocab, prompt_mean=8, max_new=4,
                               cache_len=CACHE_LEN)
    ph = TL.phase_stats(within(h.run, reqs, seconds=120), offered_qps=50.0)
    h.require_steady_state()
    assert ph["requests"] == 8 and ph["retrace_free"]
    assert ph["sustained_qps"] > 0
    assert TL.SLO(ttft_p99_s=60.0, latency_p99_s=60.0,
                  min_sustained_ratio=0.5).check(ph) == []


# ------------------------------------------------------------------ CLI
def run_cli(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *argv], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=300)


def report_of(stdout: str) -> dict:
    """The JSON report after the '# ...' progress lines."""
    return json.JSONDecoder().raw_decode(stdout[stdout.index("\n{") + 1:])[0]


def test_cli_offline_mode_in_a_subprocess(tmp_path):
    out = run_cli(["--mode", "offline", "--page-size", "8", "--cache-len",
                   "64", "--prefill-chunk", "4", "--requests", "6",
                   "--rns-verify", "--report", str(tmp_path / "r.json")],
                  tmp_path)
    assert out.returncode == 0, out.stderr
    rep = report_of(out.stdout)
    assert rep == json.loads((tmp_path / "r.json").read_text())
    assert rep["mode"] == "offline" and rep["retrace_free"]
    assert rep["requests"] == 6 and rep["tokens_out"] == 6 * 16
    assert rep["rns"] == {"slots_verified": 6, "slots_failed": 0}
    assert rep["buckets"]["widths"] == [8, 16, 32, 64]
    assert rep["paging"][0]["page_size"] == 8
    assert rep["device"] == ["cpu"] and rep["n_chips"] == 1
    assert rep["tok_per_s"] > 0 and rep["ttft_s"]["n"] == 6


def test_cli_loadgen_mode_in_a_subprocess(tmp_path):
    out = run_cli(["--mode", "loadgen", "--page-size", "8", "--cache-len",
                   "64", "--qps-lo", "0.5", "--qps-hi", "8",
                   "--qps-iters", "1", "--phase-requests", "4",
                   "--prompt-mean", "8", "--max-new", "4"], tmp_path)
    assert out.returncode == 0, out.stderr
    rep = report_of(out.stdout)
    assert rep["mode"] == "loadgen" and rep["bracket"] == [0.5, 8.0]
    assert 1 <= len(rep["phases"]) <= 3
    assert all(p["retrace_free"] for p in rep["phases"])
    assert all(p["requests"] == 4 for p in rep["phases"])
    assert "# loadgen:" in out.stdout


@pytest.mark.parametrize("argv,match", [
    (["--mode", "offline", "--inject-wire-corrupt"], "drop --inject"),
    (["--mode", "loadgen", "--crypto-slots", "2"], "drop --trace"),
    (["--mode", "offline", "--buckets", "8,x"], "--buckets takes"),
])
def test_cli_mode_checks(argv, match, capsys):
    from repro_torch.launch import serve as t_serve

    with pytest.raises(SystemExit) as e:
        t_serve.main(["--device", "cpu", *argv])
    assert e.value.code != 0
    assert match in capsys.readouterr().err
