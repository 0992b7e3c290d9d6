"""A few units of work traced under ``torch.profiler``, and the reduction
of its Chrome trace to what the per-layer readers take: device busy time
(the union of kernel, memcpy and memset intervals, as
``tools/train_profile.py`` takes it), the device's own span, kernel time
and launches by name, the time of every named span (``record_function``
ranges, on the host and on the device), and the longest idle stretches of
the device labelled by the host operation running at its midpoint.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

__all__ = ["union_us", "idle_gaps", "reduce_device", "span_totals",
           "idle_by_host", "load_events", "profile_steps", "WINDOW"]

WINDOW = "portbench_window"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "python_function")
SPAN_CATS = {"user_annotation": "host_us", "gpu_user_annotation": "device_us"}
TOP = 10


def _merged(intervals, lo, hi):
    """Sorted disjoint [s, e) of the intervals clipped to [lo, hi)."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals
                       if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(intervals, lo, hi) -> float:
    """Length of the union of [s, e) intervals inside [lo, hi)."""
    return sum(e - s for s, e in _merged(intervals, lo, hi))


def idle_gaps(intervals, lo, hi):
    """The stretches of [lo, hi) that no interval covers, as (s, e)."""
    gaps, cur = [], lo
    for s, e in _merged(intervals, lo, hi):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


def _host_at(host, starts, t):
    """The innermost host event running at time t (the latest-starting one
    of the 400 before it that covers it), or None."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 400), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return None


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _kernels(dev) -> dict:
    kernels = defaultdict(lambda: [0.0, 0])
    for e in dev:
        if e["cat"] == "kernel":
            kernels[e["name"]][0] += e["dur"]
            kernels[e["name"]][1] += 1
    return {k: tuple(v) for k, v in kernels.items()}


def _top_kernels(kernels) -> list:
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[k, v[0] / 1e6] for k, v in top]


def reduce_device(events, window_us: float) -> dict:
    """A trace of the device alone over a window the host clock measured
    (every device event of the trace lies in it): window and busy
    microseconds, the device's span (first start to last end of its
    events), kernel microseconds and launches by name, and the ten kernels
    that took most device time, in seconds."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    kernels = _kernels(dev)
    lo = min((s for s, _ in iv), default=0.0)
    hi = max((e for _, e in iv), default=0.0)
    return {"window_us": window_us, "busy_us": min(union_us(iv, lo, hi),
                                                   window_us),
            "device_span_us": hi - lo, "kernels": kernels,
            "launches": sum(n for _, n in kernels.values()),
            "breakdown": {"device_ops": _top_kernels(kernels)}}


def span_totals(events, skip=WINDOW) -> dict:
    """Per ``record_function`` name (the window's own span left out): the
    microseconds of its host ranges (``host_us``), of its ranges on the
    device (``device_us``, first to last kernel of a range) and the host
    ranges' count."""
    out: dict = {}
    for e in events:
        key = SPAN_CATS.get(e.get("cat"))
        if e.get("ph") != "X" or key is None or e.get("name") == skip:
            continue
        s = out.setdefault(e["name"], {"host_us": 0.0, "device_us": 0.0,
                                       "count": 0})
        s[key] += e["dur"]
        s["count"] += key == "host_us"
    return out


def idle_by_host(events, span: str) -> list:
    """The host operations under which the device sat idle longest, in a
    trace with the host's operators: each idle stretch of the window (the
    host span named ``span``, which ends after a device synchronize) is
    labelled by the innermost host operation running at its midpoint;
    the ten largest totals, in seconds."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"trace: {len(spans)} spans named {span!r}")
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    iv = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
          and e.get("cat") in DEVICE_CATS and lo <= e["ts"] < hi]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("name") != span and lo <= e["ts"] < hi)
    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    for s, e in idle_gaps(iv, lo, hi):
        by_host[_host_at(host, starts, (s + e) / 2)
                or "(host between operators)"] += e - s
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return [[k, v / 1e6] for k, v in gaps]


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_steps(run_step, first: int, steps: int, device) -> dict:
    """``steps`` more units of work (``run_step(i)`` for i from ``first``)
    under ``torch.profiler`` twice, each segment synchronised at both
    ends.  The first traces the device alone (its host cost is small, so
    the card's idle share and launches are the untraced work's): window,
    busy time, the device's span, kernel time, launches and named spans.
    The second adds the host's operators, which slow the host several
    times over: it labels the idle stretches by what the host was doing,
    and gives the named spans' host time (``host_spans``).  Each Chrome
    trace goes to a temporary file, is reduced and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def segment(acts, j0):
        _sync(device)
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                t = time.perf_counter()
                for j in range(steps):
                    run_step(j0 + j)
                _sync(device)
                window_us = (time.perf_counter() - t) * 1e6
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            del prof
            return window_us, load_events(path)
        finally:
            os.remove(path)

    cuda = device.type == "cuda"
    window_us, events = segment(
        [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU], first)
    out = reduce_device(events, window_us)
    out["spans"] = span_totals(events)
    _, events = segment([ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else []), first + steps)
    out["breakdown"]["idle_gaps"] = idle_by_host(events, WINDOW)
    out["host_spans"] = span_totals(events)
    out["steps"] = steps
    return out
