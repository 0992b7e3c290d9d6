"""Offline replicas that span several ranks: ``replica_meshes``,
``RankReplicaSet`` and ``OfflineInference`` over four gloo CPU ranks.

The ranks run once for the module (subprocesses over a FileStore, as
``test_torch_mesh_serve.py``), as two replicas of two ranks each behind
the controller on rank 0, with a 2-layer gemma3-1b smoke model,
``rns_verify=True`` and pow2 buckets, on the batched cache and on the paged
pool.  Offline arrivals are all at t = 0, so dispatch depends only on the
capacities each tick reads, as in one process: every rank's tokens must
equal a solo engine's, rank 0's ``dispatched`` and report counts those of
the one-process ``OfflineInference(replicas=2)`` on the same requests, and
the two ranks of a replica must retire the same tokens with the same
verify log.  A two-phase ``search_max_qps`` must end with one transcript on
every rank.  Equal means equal: the counts, tokens and transcripts are
compared exactly; wall-clock numbers only for sign.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CACHE_LEN, CHUNK, SLOTS, N_REQ = 64, 8, 2, 6
LAYOUTS = {"batched": {}, "paged": {"page_size": 8, "n_pages": 18}}

CHILD = r'''
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(d + "/store", 4),
                        rank=rank, world_size=4)
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve import loadgen
from repro_torch.serve.offline import (OfflineInference, pow2_buckets,
                                       replica_meshes)
from repro_torch.serve.scheduler import Request

CACHE_LEN, CHUNK, SLOTS, N_REQ = %d, %d, %d, %d
LAYOUTS = %s
cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=2)
params = init_params(cfg, 0, "cpu")

def requests():
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=[int(x) for x in rng.integers(
                1, cfg.vocab, int(rng.integers(5, 21)))],
                    max_new=6, eos=-1) for i in range(N_REQ)]

out = {}
for name, kw in LAYOUTS.items():
    h = OfflineInference(cfg, params, n_slots=SLOTS, cache_len=CACHE_LEN,
                         prefill_chunk=CHUNK, buckets=pow2_buckets(CACHE_LEN),
                         replicas=2, rns_verify=True, **kw)
    eng = h.engines[0]
    warm = h.warmup()
    seen, log = {}, {}
    drain = eng.drain_completed
    def record():
        for k, v in eng.verify_log.items():
            log[str(k)] = bool(v)
        done = drain()
        for r in done:
            seen[str(r.rid)] = list(r.out)
        return done
    eng.drain_completed = record
    rep = h.run(requests())
    h.require_steady_state()
    eng.drain_completed = drain
    out[name] = {
        "replica": h.replica_set.replica, "n_chips": h.n_chips,
        "mesh": list(eng.mesh.mesh.tolist()), "dims": eng.mesh.mesh_dim_names,
        "placements": {k: str(v.placements) for k, v in eng.cache.items()
                       if hasattr(v, "placements")},
        "tokens": seen, "log": log, "warm": warm, "report": rep,
        "completions": (sorted([r.rid, list(r.out)] for r, _ in h.completions)
                        if rank == 0 else None),
    }
    if name == "batched":
        rng = np.random.default_rng(11)
        def make(n, qps, _c=[100]):
            _c[0] += n
            return loadgen.poisson_requests(
                n, qps, rng, vocab=cfg.vocab, prompt_mean=8, max_new=4,
                cache_len=CACHE_LEN, rid0=_c[0] - n)
        res = loadgen.search_max_qps(h, make, loadgen.SLO(), qps_lo=1.0,
                                     qps_hi=50.0, iters=0, phase_requests=4)
        out["transcript"] = json.dumps(res, sort_keys=True)
def boom(r):
    if r.rid == 201:
        raise ValueError("callback refused rid 201")
    return ""
h.callback = boom
try:
    h.run([Request(rid=200 + i, prompt=[5, 6, 7], max_new=3, eos=-1)
           for i in range(4)])
    out["callback_error"] = None
except Exception as e:
    out["callback_error"] = f"{type(e).__name__}: {e}"
try:
    replica_meshes(3, "cpu")
    out["three_of_four"] = None
except ValueError as e:
    out["three_of_four"] = str(e)
json.dump(out, open(f"{d}/out{rank}.json", "w"))
dist.destroy_process_group()
''' % (CACHE_LEN, CHUNK, SLOTS, N_REQ, repr(LAYOUTS))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("replicas")
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


@pytest.fixture(scope="module")
def one_process():
    """The solo engine's tokens and the one-process two-replica harness's
    report, per layout, in this process (no process group)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve.batcher import ContinuousBatcher
    from repro_torch.serve.offline import OfflineInference, pow2_buckets
    from repro_torch.serve.scheduler import Request

    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=2)
    params = init_params(cfg, 0, "cpu")

    def requests():
        rng = np.random.default_rng(3)
        return [Request(rid=i, prompt=[int(x) for x in rng.integers(
                    1, cfg.vocab, int(rng.integers(5, 21)))],
                        max_new=6, eos=-1) for i in range(N_REQ)]

    out = {}
    for name, kw in LAYOUTS.items():
        solo = ContinuousBatcher(cfg, params, n_slots=SLOTS,
                                 cache_len=CACHE_LEN, prefill_chunk=CHUNK,
                                 **kw)
        for r in requests():
            solo.submit(r)
        want = {str(r.rid): list(r.out) for r in solo.run_to_completion()}
        h = OfflineInference(cfg, params, n_slots=SLOTS, cache_len=CACHE_LEN,
                             prefill_chunk=CHUNK,
                             buckets=pow2_buckets(CACHE_LEN), replicas=2,
                             rns_verify=True, **kw)
        warm = h.warmup()
        out[name] = {"solo": want, "warm": warm, "report": h.run(requests())}
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_serves_the_solo_tokens(ranks, one_process, layout):
    """Each rank retires its replica's requests with the solo engine's
    tokens; the two replicas together serve every request once."""
    want = one_process[layout]["solo"]
    served = {}
    for out in ranks:
        res = out[layout]
        assert res["tokens"] and all(res["log"].values()), res
        for rid, toks in res["tokens"].items():
            assert toks == want[rid], (rid, toks, want[rid])
        served.setdefault(res["replica"], set()).update(res["tokens"])
    assert sorted(served) == [0, 1]
    assert served[0] | served[1] == set(want)
    assert not served[0] & served[1]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ranks_of_a_replica_agree(ranks, layout):
    """Ranks 0, 1 hold replica 0 and ranks 2, 3 replica 1 (one ("data",)
    mesh each), and retire the same tokens with the same verify log."""
    for a, b, replica in ((0, 1, 0), (2, 3, 1)):
        ra, rb = ranks[a][layout], ranks[b][layout]
        assert ra["replica"] == rb["replica"] == replica
        assert ra["mesh"] == rb["mesh"] == [2 * replica, 2 * replica + 1]
        assert ra["dims"] == ["data"]
        assert ra["tokens"] == rb["tokens"] and ra["log"] == rb["log"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_controller_report_matches_one_process(ranks, one_process, layout):
    """Rank 0's report: the one-process harness's dispatch, counts, census,
    buckets and pages; ``n_chips`` the four ranks; no report elsewhere."""
    got = ranks[0][layout]["report"]
    want = one_process[layout]["report"]
    for key in ("requests", "llm_requests", "tokens_out", "replicas",
                "engine_steps", "dispatched", "retrace_free", "jit_traces",
                "buckets", "paging"):
        assert got.get(key) == want.get(key), key
    assert got["n_chips"] == WORLD and want["n_chips"] == 1
    assert got["overlap"]["processed"] == N_REQ
    assert got["ttft_s"]["n"] == N_REQ and got["wall_s"] > 0
    ctl = got["control"]
    assert ctl["exchanges"] >= got["engine_steps"] // 2
    assert ctl["exchange_ms"]["n"] == ctl["exchanges"]
    assert ranks[0][layout]["completions"] == sorted(
        [int(k), v] for k, v in one_process[layout]["solo"].items())
    for out in ranks[1:]:
        assert out[layout]["report"] is None and out[layout]["n_chips"] == 4
    assert ranks[0][layout]["warm"] == one_process[layout]["warm"]


def test_cache_slot_axis_is_split_over_data(ranks):
    """``dist.sharding.cache_specs`` on a ("data",) mesh of two: the batched
    cache's slot axis and the pool's page axis split over "data"."""
    for out in ranks:
        assert out["batched"]["placements"]["k"] == "(Shard(dim=1),)"
        assert out["paged"]["placements"]["k"] == "(Shard(dim=1),)"


def test_loadgen_transcript_is_the_same_on_every_rank(ranks):
    first = json.loads(ranks[0]["transcript"])
    assert len(first["phases"]) == 2
    assert all(ph["requests"] == 4 for ph in first["phases"])
    assert all(out["transcript"] == ranks[0]["transcript"] for out in ranks)


def test_a_controller_error_reaches_every_rank(ranks):
    """A completion callback that raises on rank 0 fails the run on every
    rank (the error travels in the exchange), instead of leaving the other
    ranks waiting on a collective."""
    assert ranks[0]["callback_error"] == (
        "ValueError: callback refused rid 201")
    for out in ranks[1:]:
        assert out["callback_error"].startswith(
            "RuntimeError: the controller on rank 0 failed: ValueError(")


def test_ranks_must_divide_into_replicas(ranks):
    for out in ranks:
        assert out["three_of_four"] == ("4 ranks do not divide into 3 "
                                        "replicas: give each replica W/n "
                                        "ranks")


def test_serve_cli_under_torchrun_matches_one_process(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --mode
    offline --replicas 2`` on the CPU: one report, printed by rank 0, with
    the one-process CLI's requests, tokens, dispatch and engine steps, and
    ``n_chips`` the two ranks."""
    import contextlib
    import io

    from repro_torch.launch import serve as t_serve

    argv = ["--mode", "offline", "--replicas", "2", "--device", "cpu",
            "--cache-len", "64", "--prefill-chunk", "8", "--requests", "6",
            "--prompt-mean", "10", "--max-new", "5", "--rns-verify"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *argv],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert out.count('"requests"') == 1 and out.count("# warmup") == 1
    got = json.JSONDecoder().raw_decode(out[out.index("\n{") + 1:])[0]
    with contextlib.redirect_stdout(io.StringIO()):
        want, _ = t_serve.main(argv)
    for key in ("requests", "tokens_out", "dispatched", "engine_steps",
                "replicas", "retrace_free", "jit_traces", "rns"):
        assert got[key] == want[key], key
    assert got["n_chips"] == 2 and want["n_chips"] == 1
    assert got["control"]["exchanges"] > 0
