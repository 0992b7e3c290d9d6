"""The serve engine with ``mesh=`` over two gloo CPU ranks, a (data 1,
model 2) mesh: every rank runs the same engine on the same requests.

With a 2-layer gemma3-1b smoke model (one KV head, so the batched cache
falls back to sharding its sequence axis over "model", and a pool of an
even page count shards its page axis) the tokens, the verify log and every
cache leaf gathered whole must equal the engine without a mesh, on every
rank, for the batched cache and the paged pool.  The ranks run once for
the module.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2

CHILD = r'''
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, d = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(d + "/store", 2),
                        rank=rank, world_size=2)
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.scheduler import Request

cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=2)
params = init_params(cfg, 0, "cpu")
mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
rng = np.random.default_rng(0)
prompts = [[int(x) for x in rng.integers(1, cfg.vocab, 10 + 3 * i)]
           for i in range(3)]

def run(m, **kw):
    eng = ContinuousBatcher(cfg, params, n_slots=2, cache_len=64,
                            prefill_chunk=8, rns_verify=True, mesh=m, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new=5))
    toks = sorted((r.rid, list(r.out)) for r in eng.run_to_completion())
    return toks, {str(k): v for k, v in eng.verify_log.items()}, eng

out = {}
for name, kw in (("batched", {}), ("paged", {"page_size": 8,
                                             "n_pages": 18})):
    want, wlog, e0 = run(None, **kw)
    got, glog, e1 = run(mesh, **kw)
    leaves = {k: [str(v.placements),
                  torch.equal(v.full_tensor(), e0.cache[k])]
              for k, v in e1.cache.items() if hasattr(v, "placements")}
    out[name] = {"tokens": got == want, "log": glog == wlog and
                 all(wlog.values()), "leaves": leaves, "got": got}
json.dump(out, open(f"{d}/out{rank}.json", "w"))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
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


@pytest.mark.parametrize("layout", ["batched", "paged"])
def test_engine_on_mesh_matches_no_mesh(ranks, layout):
    for out in ranks:
        res = out[layout]
        assert res["tokens"] and res["log"]
        assert res["leaves"] and all(eq for _, eq in res["leaves"].values())
    assert ranks[0][layout]["got"] == ranks[1][layout]["got"]


def test_cache_is_sharded_by_cache_specs(ranks):
    """One KV head does not divide the model axis: the batched cache
    shards its sequence axis, the paged pool its page axis."""
    batched, paged = ranks[0]["batched"]["leaves"], ranks[0]["paged"]["leaves"]
    assert batched["k"][0] == "(Replicate(), Shard(dim=2))"
    assert paged["k"][0] == "(Replicate(), Shard(dim=1))"
