"""The reference against the port at small shapes on the CPU, for each
entry: in f32 the two agree to the order of operations, so every gap is
rounding; in the configurations' bf16 the run is correct under each
cell's limits; the repairing entry finds every planted fault.  The
reference's SSD is held against the plain recurrence it stands for."""
import json
import time

import pytest
import torch

from conftest import ROOT, SMALL_TRAFFIC, small_model
from portbench import harness
from portbench.reference import model as ref_model, rrns

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(cell, seed, lines=None, **model_over):
    config = cell.split(".")[0]
    return harness.run_cell(ROOT, cell, seed, 0.0, False, "cpu",
                            time.perf_counter(),
                            model=small_model(config, **model_over),
                            traffic=SMALL_TRAFFIC,
                            log=(lambda *a: None) if lines is None
                            else lines.append)


@pytest.mark.parametrize("cell", CELLS)
def test_f32_program_matches_the_reference(cell):
    lines = []
    r = _run(cell, 2**31 + 11, lines, dtype="float32")
    gaps = next(json.loads(ln) for ln in lines if '"numbers"' in ln)
    # f32 on both sides: the gaps are the rounding of two orders of the
    # same sums (1e-7 to 2e-5 seen), far under bf16's 2**-8
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4 and gaps["update_gap"] < 1e-4
    assert gaps.get("repair_miss", 0) == 0
    assert r["correct"] and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_program_is_correct_under_the_cells_limits(cell):
    r = _run(cell, 977)
    assert r["correct"], r["checks"]


def test_repair_finds_every_planted_fault():
    r = _run("mamba2_370m.train_rrns", 31)
    assert r["checks"]["repair_miss"]["value"] == 0
    assert r["attempted"] >= 1 and r["failed"] == 0


def _recurrence(X, a, B, C):
    b, s, h, p = X.shape
    S = torch.zeros(b, h, B.shape[-1], p, dtype=X.dtype)
    ys = []
    for t in range(s):
        S = torch.exp(a[:, t])[..., None, None] * S + (
            B[:, t, None, :, None] * X[:, t, :, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], S))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("chunk", [4, 16])
def test_reference_ssd_is_the_recurrence(chunk):
    g = torch.Generator().manual_seed(3)
    b, s, h, p, n = 2, 32, 3, 4, 5
    X = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    a = -torch.rand(b, s, h, generator=g, dtype=torch.float64)
    B = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, s, n, generator=g, dtype=torch.float64)
    torch.testing.assert_close(ref_model.ssd(X, a, B, C, chunk),
                               _recurrence(X, a, B, C), rtol=1e-10,
                               atol=1e-10)


def test_codec_moduli_are_the_papers_construction():
    four = {"n": 3, "bits": 15, "correct": False}
    five = {"n": 3, "bits": 15, "correct": True}
    assert rrns.codec_moduli(four) == ((32749, 32719, 32717), (32713,))
    assert rrns.codec_moduli(five) == ((32717, 32713, 32707),
                                       (32749, 32719))
    X = 123_456_789_012
    col = [X % m for m in rrns.channel_moduli(five)]
    assert rrns.column_ok(col, five)
    col[1] = (col[1] + 1) % 32713
    assert not rrns.column_ok(col, five)
