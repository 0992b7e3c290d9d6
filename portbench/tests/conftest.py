"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
repository root (the repository's tier-1 run collects ``tests/`` only).
Puts the repository root and ``src/`` on sys.path, and gives the small
shapes the CPU runs use."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each configuration at a width the CPU runs in seconds, bf16 compute
SMALL = {
    "mamba2_370m": dict(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                        ssm_headdim=16, ssm_chunk=16),
}
SMALL_TRAFFIC = {"batch": 2, "seq": 64, "pool": 4}


def small_model(config: str, **over) -> dict:
    m = json.loads((ROOT / "portbench" / "configs" /
                    f"{config}.json").read_text())["model"]
    return dict(m, **SMALL[config], **over)


@pytest.fixture
def root():
    return ROOT
