"""The harness is driven by data: a configuration, a traffic mix, a cell,
a per-layer metric, an entry and a model family added as new files (and
entries) are found by name, with no file that was there edited;
``BENCHMARK.json`` keeps to the shape the benchmark's contract gives it."""
import hashlib
import json
import re
import shutil
import time

import torch

from conftest import ROOT, SMALL, SMALL_TRAFFIC
from portbench import counts, harness, inputs, training

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in tmp_path.rglob("*") if p.is_file()}


def _changed(tmp_path, before):
    return [str(p.relative_to(tmp_path)) for p, h in before.items()
            if hashlib.sha256(p.read_bytes()).hexdigest() != h]


def _add(bench_path, group, entry):
    bench = json.loads(bench_path.read_text())
    bench[group].append(entry)
    bench_path.write_text(json.dumps(bench))


def test_new_files_are_found_by_name(tmp_path):
    before = _copy(tmp_path)
    pb, bench = tmp_path / "portbench", tmp_path / "BENCHMARK.json"
    conf = json.loads((pb / "configs" / "mamba2_370m.json").read_text())
    conf["name"] = "tiny_ssm"
    conf["model"].update(SMALL["mamba2_370m"])
    (pb / "configs" / "tiny_ssm.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "rns_8x2048.json").read_text())
    mix.update(SMALL_TRAFFIC)
    (pb / "traffic" / "rns_tiny.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny_ssm.train_rns.json").write_text(json.dumps(
        {"loss_gap": 0.01, "grad_gap": 0.1, "update_gap": 0.1}))
    (pb / "metrics" / "steps_traced.py").write_text(
        "def read(rec):\n    return float(rec['trace']['steps'])\n")
    # the only edit: BENCHMARK.json gains entries
    _add(bench, "configs", {"name": "tiny_ssm", "source": "test",
                            "file": "portbench/configs/tiny_ssm.json",
                            "reduced": [], "why": "test"})
    _add(bench, "workloads", {"name": "tiny_ssm.train_rns",
                              "config": "tiny_ssm", "traffic": "rns_tiny",
                              "chips": 1, "why": "test"})
    _add(bench, "per_layer", {"name": "steps_traced", "unit": "steps",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves":
                              "train_tokens_per_s",
                              "workloads": ["tiny_ssm.train_rns"]})

    cell = harness.load_cell(tmp_path, "tiny_ssm.train_rns")
    assert cell.config["model"]["d_model"] == 64
    assert cell.traffic["seq"] == SMALL_TRAFFIC["seq"]
    assert cell.limits["grad_gap"] == 0.1
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    assert harness.load_plugin(tmp_path, "metrics", "steps_traced").read(
        {"trace": {"steps": 3}}) == 3.0

    # and the new cell runs, traced, reporting the new metric
    r = harness.run_cell(tmp_path, "tiny_ssm.train_rns", 7, 0.0, True, "cpu",
                         time.perf_counter(), log=lambda *a: None)
    assert r["correct"] and r["metrics"]["steps_traced"]["value"] == 3.0
    assert _changed(tmp_path, before) == ["BENCHMARK.json"]


ECHO_ENTRY = '''
"""A test entry: no program, a fixed answer, its own end-to-end metric."""


def run(ctx):
    ctx.log("echo " + ctx.cell.name)
    return {"setup_s": 0.25, "attempted": 4, "failed": 0,
            "numbers": {"answer_gap": 0.0}, "memory_peak_bytes": 0,
            "values": {"answers_per_s": 8.0, "setup_s": 0.25},
            "record": {"answers": 4}, "traced": None}


def control(ctx):
    return {"answer_gap": 1.0}


FAULTS = {}
'''

TINY_FAMILY = '''
"""A test family: one dense matrix between a tied embedding and logits."""
from portbench.reference import model as blocks

STACKED = {}


def param_spec(m):
    d = m["d_model"]
    return [(("embed",), (m["vocab"], d), "n0.02"),
            (("w",), (d, d), "n0.02"), (("norm",), (d,), "zeros")]


def logits(params, m, tokens, mm):
    x = params["embed"][tokens]
    x = blocks.rms_norm(mm(x, params["w"]), params["norm"], m["norm_eps"])
    return mm(x, params["embed"].T)


def matrix_params_applied(m):
    return m["d_model"] * m["d_model"] + m["vocab"] * m["d_model"]


def seq_flops_per_token(m, seq):
    return 0.0
'''


def test_a_new_entry_and_a_new_family_are_found_by_name(tmp_path):
    """An entry that is no training step, with an end-to-end metric of its
    own, runs as a cell; a model family's layout, reference and counts
    come from its own file."""
    before = _copy(tmp_path)
    pb, bench = tmp_path / "portbench", tmp_path / "BENCHMARK.json"
    (pb / "entries" / "echo.py").write_text(ECHO_ENTRY)
    (pb / "families" / "tiny_dense.py").write_text(TINY_FAMILY)
    (pb / "traffic" / "echo_4.json").write_text(json.dumps(
        {"entry": "echo"}))
    (pb / "limits" / "mamba2_370m.echo.json").write_text(json.dumps(
        {"answer_gap": 0}))
    _add(bench, "workloads", {"name": "mamba2_370m.echo",
                              "config": "mamba2_370m", "traffic": "echo_4",
                              "chips": 1, "why": "test"})
    _add(bench, "end_to_end", {"name": "answers_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["mamba2_370m.echo"]})
    lines = []
    r = harness.run_cell(tmp_path, "mamba2_370m.echo", 7, 1.0, False, "cpu",
                         time.perf_counter(), log=lines.append)
    assert lines == ["echo mamba2_370m.echo"]
    assert r["correct"] and set(r["metrics"]) == {"answers_per_s", "setup_s"}
    assert r["metrics"]["answers_per_s"]["value"] == 8.0

    fam = harness.load_plugin(tmp_path, "families", "tiny_dense")
    m = {"family": "tiny_dense", "d_model": 16, "vocab": 32,
         "norm_eps": 1e-6}
    params = inputs.init_params(fam, m, 3, "cpu")
    assert params["w"].shape == (16, 16) and params["norm"].abs().sum() == 0
    assert counts.grad_elements(fam, m) == 32 * 16 + 16 * 16 + 16
    assert counts.model_flops_per_step(fam, m, 2, 8) == 6 * 16 * (256 + 512)
    pool = inputs.batch_pool(32, {"seq": 8, "batch": 2, "pool": 2}, 3, "cpu")
    tr = {"setup_steps": 2, "optimizer": json.loads(
        (pb / "traffic" / "plain_8x2048.json").read_text())["optimizer"]}
    ref = training.reference(fam, m, tr, 3, pool, torch.device("cpu"))
    assert len(ref["losses"]) == 2 and set(ref["grad"]) == set(params)
    assert _changed(tmp_path, before) == ["BENCHMARK.json"]


def _names(entries):
    return [e["name"] for e in entries]


def test_benchmark_json_keeps_to_its_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith(
        "portbench/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    all_names = (_names(b["configs"]) + _names(b["workloads"])
                 + _names(b["end_to_end"]) + _names(b["per_layer"]))
    assert all(NAME.match(n) for n in all_names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len(set(_names(b[group]))) == len(b[group])
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
    cells = _names(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        traffic = json.loads((ROOT / "portbench" / "traffic" /
                              f"{w['traffic']}.json").read_text())
        assert (ROOT / "portbench" / "entries" /
                f"{traffic['entry']}.py").is_file()
        model = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert (ROOT / "portbench" / "families" /
                f"{model['model']['family']}.py").is_file()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()
    assert {c for w in b["workloads"] for c in [w["config"]]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(cells)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_no_more_than_a_quarter_of_the_cells_take_four_chips():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
