"""The import guard: the benchmark measures the PyTorch port alone.

``loaded_forbidden`` compares the top-level name of every loaded module
(the part before the first dot) whole against the JAX stack and the JAX
package, so ``repro_torch`` passes where ``repro`` does not.
``source_reads_forbidden`` checks that no Python file of the benchmark
names the JAX package's benchmark folder or its result files.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

__all__ = ["FORBIDDEN", "loaded_forbidden", "source_reads_forbidden"]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the JAX package's benchmark folder and result files, spelt in parts so
# that this file does not name them
_READS = re.compile("bench" + r"marks/|BENCH" + r"_[A-Za-z0-9_*]*\.json")


def loaded_forbidden(modules=None) -> list[str]:
    """Loaded module names whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def source_reads_forbidden(root=None) -> list[str]:
    """Python files under the benchmark folder that name the JAX
    package's benchmark folder or its result files."""
    root = Path(root or Path(__file__).resolve().parent)
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                  if _READS.search(p.read_text()))
