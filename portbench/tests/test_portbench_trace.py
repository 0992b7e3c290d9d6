"""The trace reduction on a synthetic trace with overlapping intervals."""
import pytest

from portbench import trace


def test_union_merges_overlaps_and_clips_to_the_window():
    iv = [(0, 10), (5, 15), (20, 30), (28, 29), (40, 50)]
    assert trace.union_us(iv, 0, 100) == 15 + 10 + 10
    assert trace.union_us(iv, 8, 45) == 7 + 10 + 5      # clipped both ends
    assert trace.union_us([], 0, 10) == 0


def test_idle_gaps_are_what_the_union_leaves():
    iv = [(5, 15), (0, 10), (20, 30)]
    assert trace.idle_gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert trace.idle_gaps(iv, -5, 30) == [(-5, 0), (15, 20)]


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_device_busy_launches_and_top_kernels():
    events = [
        _ev("kernel", "gemm", 100, 30),
        _ev("kernel", "gemm", 120, 30),                   # overlaps: 100-150
        _ev("gpu_memcpy", "Memcpy HtoD", 160, 10),        # busy, no launch
        _ev("kernel", "codec_encode_kernel", 190, 5),
        _ev("cpu_op", "aten::mm", 100, 99),               # host: not counted
    ]
    out = trace.reduce_device(events, 100.0)
    assert out["window_us"] == 100.0
    assert out["busy_us"] == 50 + 10 + 5
    assert out["device_span_us"] == 195 - 100
    assert out["launches"] == 3
    assert out["kernels"]["gemm"] == (60.0, 2)
    ops = dict(out["breakdown"]["device_ops"])
    assert ops == pytest.approx({"gemm": 60e-6, "codec_encode_kernel": 5e-6})


def test_idle_stretches_are_labelled_by_the_host_operation():
    events = [
        _ev("user_annotation", "win", 100, 100),          # the window
        _ev("kernel", "gemm", 100, 30),
        _ev("kernel", "gemm", 120, 30),
        _ev("gpu_memcpy", "Memcpy HtoD", 160, 10),
        _ev("kernel", "codec_encode_kernel", 190, 5),
        _ev("kernel", "outside", 300, 50),                # after the window
        _ev("cpu_op", "aten::mm", 100, 99),
        _ev("cpu_op", "aten::copy_", 150, 8),             # covers 155
        _ev("cuda_runtime", "cudaLaunchKernel", 176, 10),  # covers 180
    ]
    gaps = dict(trace.idle_by_host(events, "win"))
    # idle 150-160 (midpoint 155: aten::copy_), 170-190 (180: the launch),
    # 195-200 (197.5: aten::mm, the innermost still running)
    assert gaps == pytest.approx({"aten::copy_": 10e-6,
                                  "cudaLaunchKernel": 20e-6,
                                  "aten::mm": 5e-6})


def test_named_spans_are_totalled_on_host_and_device():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 500),     # left out
        _ev("user_annotation", "ssm.ssd", 10, 40),
        _ev("user_annotation", "ssm.ssd", 100, 60),
        _ev("gpu_user_annotation", "ssm.ssd", 30, 70),
        _ev("gpu_user_annotation", "attn", 200, 5),
        _ev("kernel", "gemm", 30, 20),
    ]
    assert trace.span_totals(events) == {
        "ssm.ssd": {"host_us": 100.0, "device_us": 70.0, "count": 2},
        "attn": {"host_us": 0.0, "device_us": 5.0, "count": 0}}


def test_profiled_steps_keep_the_programs_spans():
    """On the CPU, a span the traced work opens reaches the record."""
    import torch
    from torch.profiler import record_function

    def work(i):
        with record_function("stage.a"):
            torch.ones(64, 64) @ torch.ones(64, 64)

    out = trace.profile_steps(work, 0, 2, torch.device("cpu"))
    assert out["steps"] == 2 and out["window_us"] > 0
    assert out["spans"]["stage.a"]["count"] == 2
    assert out["host_spans"]["stage.a"]["count"] == 2


def test_the_host_trace_needs_one_window_span():
    with pytest.raises(RuntimeError):
        trace.idle_by_host([_ev("kernel", "k", 0, 1)], "win")
