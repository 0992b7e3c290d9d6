"""Arithmetic the per-layer readers (``portbench/metrics/*.py``) share.

Each reader takes the record of a traced run (``harness.run_cell``),
``cell``, ``peaks`` (``counts.PEAKS``) and ``trace``
(``trace.profile_steps``: ``steps`` traced, ``window_us``, ``busy_us``,
``device_span_us``, ``kernels`` (microseconds and launches by name),
``launches``, ``spans`` and ``host_spans`` (microseconds by
``record_function`` name, on the device and on the host), ``breakdown``),
beside what the cell's entry records; a training entry
(``training.run``): ``stage_ms`` (per stage, each window step's ms from
the CUDA events around the functions ``repro_torch.train.train_step``
calls), ``counts`` (elements, channels, model FLOPs, from ``counts.py``),
``host_call_ms``, ``steps``, ``window_s``, ``tokens_per_step``.  A reader
that finds nothing to read returns None.
"""
from __future__ import annotations

__all__ = ["stage_mean", "roofline_pct"]


def stage_mean(rec, add, sub=()):
    """Mean over the window's steps of sum(add stages) - sum(sub stages);
    None when a stage to add never ran."""
    st = rec["stage_ms"]
    if any(not st.get(k) for k in add):
        return None
    n = len(st[add[0]])
    return sum(sum(st[k][i] for k in add)
               - sum(st[k][i] for k in sub if st.get(k))
               for i in range(n)) / n


def roofline_pct(rec, name_part: str, bytes_per_step: float):
    """The share of their bandwidth roofline, in %, of the kernels whose
    name holds ``name_part``: the bytes they must move a step at the
    card's HBM peak, over their device seconds a traced step; None when
    none ran."""
    tr = rec["trace"]
    us = [us for k, (us, _) in tr["kernels"].items() if name_part in k]
    if not us or bytes_per_step <= 0:
        return None
    t = sum(us) / 1e6 / tr["steps"]
    return 100.0 * bytes_per_step / rec["peaks"]["hbm_bytes_per_s"] / t
