"""The control, the reference with fp8 products in the program's place
(``reference/fp8.py``), comes out not correct: on the card at the cell's
own size under the cell's limits (the readings ``calibrate.py`` sets the
limits from), and on the CPU at small shapes, where every gap is smaller,
it reads the gradient gap three times or more above the bf16 program's,
the separation the limits sit in."""
import json
import time

import pytest
import torch

from conftest import ROOT, SMALL_TRAFFIC, small_model
from portbench import calibrate, check, harness

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (55, 56)


def _control(cell, seed, model, traffic, device):
    c = harness.load_cell(ROOT, cell)
    tr = dict(c.traffic, **traffic)
    ctx = harness.Run(root=ROOT, cell=c, model=model, traffic=tr,
                      family=harness.load_plugin(ROOT, "families",
                                                 model["family"]),
                      seed=seed, seconds=0.0, trace=False,
                      device=torch.device(device), t0=0.0)
    return harness.load_plugin(ROOT, "entries", tr["entry"]).control(ctx)


def _program_grad_gap(cell, seed, model):
    lines = []
    harness.run_cell(ROOT, cell, seed, 0.0, False, "cpu",
                     time.perf_counter(), model=model, traffic=SMALL_TRAFFIC,
                     log=lines.append)
    return next(json.loads(ln) for ln in lines if '"numbers"' in ln)[
        "grad_gap"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_separates_from_the_program_at_small_shapes(cell):
    model = small_model(cell.split(".")[0])
    control = min(_control(cell, s, model, SMALL_TRAFFIC, "cpu")["grad_gap"]
                  for s in SEEDS)
    program = max(_program_grad_gap(cell, s, model) for s in SEEDS)
    assert control >= 3 * program, (control, program)


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0, 1.0625, -3.3])
    q = torch.tensor([448.0, 1.0, 1.0, -3.25])      # 1.0625 -> 1 (ties even)
    from portbench.reference.fp8 import round_fp8

    torch.testing.assert_close(round_fp8(t, torch.float8_e4m3fn), q)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    s = calibrate.calibrate(ROOT, cell, [], [7], [], torch.device("cuda", 0),
                            emit=lambda *a: None)
    assert not check.judge(s["control_min"],
                           harness.load_cell(ROOT, cell).limits)
