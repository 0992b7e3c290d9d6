"""The readers of the program's spans (``ssd_ms``, ``recompute_ms``,
``repair_mrc_ms``) on hand-made trace records."""
import pytest

from conftest import ROOT
from portbench import harness


def read(metric, rec):
    return harness.load_plugin(ROOT, "metrics", metric).read(rec)


def span(device_us, host_us=1.0, count=1):
    return {"host_us": host_us, "device_us": device_us, "count": count}


def record(spans=None, host_spans=None, steps=2):
    return {"trace": {"steps": steps, "spans": spans or {},
                      "host_spans": host_spans or {}}}


TRAIN = {"ssm.ssd": span(3000.0), "ssm.ssd.bwd": span(5000.0),
         "remat.recompute": span(7000.0), "train.forward": span(9000.0)}


def test_an_absent_span_reads_none():
    for metric in ("ssd_ms", "recompute_ms", "repair_mrc_ms"):
        assert read(metric, record()) is None, metric
        assert read(metric, {"trace": None}) is None, metric
    # the SSD needs both its forward and its backward
    assert read("ssd_ms", record(host_spans={
        "ssm.ssd": span(3000.0)})) is None


def test_a_span_with_no_device_range_reads_none():
    """A run with no card records host ranges only."""
    host_only = {k: span(0.0, host_us=50.0) for k in TRAIN}
    assert read("ssd_ms", record(host_only, host_only)) is None
    assert read("recompute_ms", record(host_only, host_only)) is None


def test_the_device_only_segment_is_preferred():
    rec = record(spans={"ssm.ssd": span(1000.0), "ssm.ssd.bwd": span(0.0)},
                 host_spans=TRAIN)
    # ssm.ssd from the device-only trace, ssm.ssd.bwd (no device range
    # there) from the trace with the host's operators
    assert read("ssd_ms", rec) == pytest.approx((1000.0 + 5000.0) / 1e3 / 2)
    assert read("recompute_ms", rec) == pytest.approx(7000.0 / 1e3 / 2)


def test_the_readings_are_per_step():
    for steps in (1, 3):
        rec = record(host_spans=TRAIN, steps=steps)
        assert read("ssd_ms", rec) == pytest.approx(8.0 / steps)
        assert read("recompute_ms", rec) == pytest.approx(7.0 / steps)


def test_the_mrc_reads_only_where_the_repair_runs():
    assert read("repair_mrc_ms", record(host_spans=TRAIN)) is None
    rrns = dict(TRAIN, **{"rrns.mrc": span(66000.0, count=110)})
    assert read("repair_mrc_ms", record(host_spans=rrns, steps=3)) == (
        pytest.approx(22.0))
