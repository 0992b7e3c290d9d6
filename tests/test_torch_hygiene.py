"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
scripts in ``tools/`` import neither JAX nor anything of the JAX package
``repro``.

Checked twice: by importing every module of the port in a fresh interpreter
and listing ``sys.modules``, and by scanning the sources for such imports.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(r"^\s*(?:from|import)\s+(?:jax|repro)(?:[.\s,]|$)", re.M)


def port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    mods = list(port_modules())
    assert "repro_torch.kernels.ops" in mods and "repro_torch.quickstart" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'repro', 'jaxlib'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert ROOT / "tools" / "mont_attribution.py" in files
    offenders = {str(f.relative_to(ROOT)): _FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert {k: v for k, v in offenders.items() if v} == {}
    # the pattern does catch what it must, and spares the port's own name
    assert _FORBIDDEN.findall("import jax\nfrom repro.core import x\n")
    assert not _FORBIDDEN.findall("from repro_torch.core import x\n")
