"""A run with the timed path broken underneath comes out not correct: past
the harness's look for a card (driven on the CPU at small shapes), once
for each fault a training cell can have.  One card, one rank: there is
no exchange between chips to leave out, and a training step produces no
token to alter; the repairing cell adds its own fault, a repair that
does nothing."""
import json
import time

import pytest

from conftest import ROOT, SMALL_TRAFFIC, small_model
from portbench import harness

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _fault(cell, name):
    entry = harness.load_cell(ROOT, cell).traffic["entry"]
    return harness.load_plugin(ROOT, "entries", entry).FAULTS[name]


def _run(cell, seed, wrap=None):
    return harness.run_cell(ROOT, cell, seed, 0.0, False, "cpu",
                            time.perf_counter(),
                            model=small_model(cell.split(".")[0]),
                            traffic=SMALL_TRAFFIC, wrap_step=wrap,
                            log=lambda *a: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(cell, fault):
    r = _run(cell, 4242, _fault(cell, fault))
    assert not r["correct"], r["checks"]
    if fault == "state_unchanged":   # nothing moved: both gaps read 1
        assert r["checks"]["update_gap"]["value"] == pytest.approx(1.0)
        assert r["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_a_repair_that_does_nothing_is_not_correct():
    cell = "mamba2_370m.train_rrns"
    r = _run(cell, 4243, _fault(cell, "repair_skipped"))
    assert not r["correct"]
    assert r["checks"]["repair_miss"]["value"] >= 1
    assert r["failed"] >= 1
