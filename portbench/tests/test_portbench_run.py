"""The runner fails, and prints no result, where it cannot measure the
port: without a card, and in a checkout that holds only the benchmark."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

ARGS = ["--workload", "mamba2_370m.train_rns", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _results(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    return [json.loads(ln) for ln in lines if "correct" in json.loads(ln)]


def test_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert _results(out.stdout) == []
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path):
    """Past the card check (here driven on the CPU), a directory holding
    only ``BENCHMARK.json`` and ``portbench/`` has no program to import."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [%r]\n"
            "from portbench import harness\n"
            "print(harness.run_cell(%r, 'mamba2_370m.train_rns', 1, 0.0, "
            "False, 'cpu', 0.0))\n" % (str(tmp_path), str(tmp_path)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    assert "correct" not in out.stdout
