"""The import guard: whole top-level names, so the port passes, and no file
of the benchmark names the JAX package's benchmark folder or results."""
import subprocess
import sys

from conftest import ROOT
from portbench import guard


def test_top_level_names_compare_whole():
    mods = {"repro_torch": 0, "repro_torch.train.train_step": 0,
            "reproduce": 0, "jaxtyping": 0, "portbench.harness": 0}
    assert guard.loaded_forbidden(mods) == []
    mods.update({"repro": 0, "repro.core.mrc": 0, "jax": 0,
                 "jaxlib.xla_client": 0, "flax.linen": 0})
    assert guard.loaded_forbidden(mods) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro", "repro.core.mrc"]


def test_no_benchmark_file_reads_the_jax_packages_results():
    assert guard.source_reads_forbidden() == []


def test_source_scan_finds_a_file_that_reads_them(tmp_path):
    (tmp_path / "ok.py").write_text("x = 'portbench/configs'\n")
    (tmp_path / "bad.py").write_text(
        "open('bench" "marks/run.py'); open('BENCH" "_serve.json')\n")
    assert guard.source_reads_forbidden(tmp_path) == ["bad.py"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """What a run imports (the harness, the reference and every module of
    the port it drives), in a fresh process, passes the guard."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import portbench.harness, portbench.calibrate\n"
            "import portbench.training\n"
            "import repro_torch.launch.train, repro_torch.train.train_step\n"
            "import repro_torch.dist.grad_codec, repro_torch.kernels.build\n"
            "from portbench import guard; print(guard.loaded_forbidden())\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
