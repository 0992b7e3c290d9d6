"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py`` and the
scripts in ``tools/`` import neither JAX nor anything of the JAX package
``repro``.

Checked twice: by importing every module of the port in a fresh interpreter
and listing ``sys.modules``, and by scanning the sources for such imports.
And the port's layers point down: no module of ``kernels`` or ``core``
imports one of the layers above them, not even inside a function.  The
two count as one layer here: ``core`` reaches ``kernels.ops`` from inside
functions to route its fused paths.
"""
import ast
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


LOWER = ("kernels", "core")
UPPER = ("dist", "models", "train", "serve", "launch")


def imported(source: str, package: tuple[str, ...]):
    """Every module an ``import`` statement of ``source`` names, at any
    depth, relative imports resolved against ``package`` (the dotted
    package the module sits in); ``from a import b`` names ``a`` and
    ``a.b``."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = list(package[:len(package) - node.level + 1]
                         if node.level else ())
            base = ".".join(parts + ([node.module] if node.module else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def reaches_up(source: str, package: tuple[str, ...]) -> list[str]:
    return sorted({m for m in imported(source, package)
                   if m.split(".")[:2] in [["repro_torch", u] for u in UPPER]})


def test_kernels_and_core_import_no_layer_above():
    files = [f for layer in LOWER
             for f in sorted((PORT / layer).rglob("*.py"))]
    assert PORT / "kernels" / "ops.py" in files
    offenders = {}
    for f in files:
        package = f.relative_to(PORT.parent).parts[:-1]
        up = reaches_up(f.read_text(), package)
        if up:
            offenders[str(f.relative_to(ROOT))] = up
    assert offenders == {}
    # the scan does catch what it must: a relative import inside a
    # function, an absolute one, a layer imported by name
    pkg = ("repro_torch", "kernels")
    assert reaches_up("def f():\n    from ..dist.grad_codec import g\n",
                      pkg) == ["repro_torch.dist.grad_codec",
                               "repro_torch.dist.grad_codec.g"]
    assert reaches_up("import repro_torch.models.ssm\n", pkg)
    assert reaches_up("from .. import train\n", pkg) == ["repro_torch.train"]
    assert not reaches_up("from ..core.base import RNSBase\n"
                          "from . import build\nimport torch\n", pkg)
