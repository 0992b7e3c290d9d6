"""Device time of the program's own spans (``repro_torch.spans``), for the
readers of ``portbench/metrics/`` that read them.

A span's device range (``gpu_user_annotation``) runs from the first to the
last kernel the profiler puts under it, which is each kernel's innermost
open range.  The readers take it from the trace of the device alone
(``trace["spans"]``) where the span has one there, else from the trace
with the host's operators (``trace["host_spans"]``), which records the
program's ranges whatever the other does.
"""
from __future__ import annotations

__all__ = ["span_ms"]


def span_ms(rec, names):
    """Device ms a traced step of the spans ``names`` together; None when
    one of them has no device range in either segment (absent, or a run
    with no card)."""
    tr = rec.get("trace")
    if not tr:
        return None
    total = 0.0
    for name in names:
        us = [seg[name]["device_us"] for seg in (tr.get("spans") or {},
                                                 tr.get("host_spans") or {})
              if name in seg and seg[name]["device_us"] > 0]
        if not us:
            return None
        total += us[0]
    return total / 1e3 / tr["steps"]
