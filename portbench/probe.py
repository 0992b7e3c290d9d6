"""Stage timings of the port's training step, taken from the benchmark's
side (the ``TrainProbe`` of ``chip_smoke.py``, with ``_repair`` added):
the functions ``repro_torch.train.train_step`` calls are wrapped for the
traced run, each call between two CUDA events, and read once the window
has closed.  Install before the step is built: ``make_train_step`` binds
``adamw_update`` when it runs.
"""
from __future__ import annotations

import time

import torch

__all__ = ["StageProbe"]


class _HostEvent:
    """A CUDA event's interface on the host clock, for a CPU run (where
    every op has finished when it returns)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class StageProbe:
    NAMES = ("value_and_grad", "tree_pack_rns", "psum", "tree_decode",
             "adamw_update", "_repair")

    def __init__(self, device):
        from repro_torch.train import train_step

        self.ts, self.cuda = train_step, torch.device(device).type == "cuda"
        self.steps: list[dict] = []

    def _event(self):
        return (torch.cuda.Event(enable_timing=True) if self.cuda
                else _HostEvent())

    def __enter__(self):
        self.orig = {n: getattr(self.ts, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(self.ts, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ts, n, fn)

    def _wrap(self, name):
        stage = {"value_and_grad": "fwd_bwd", "tree_pack_rns": "pack",
                 "psum": "wire_psum", "tree_decode": "decode",
                 "adamw_update": "adamw", "_repair": "repair"}[name]
        orig = self.orig[name]

        def run(*args, **kw):
            if name == "value_and_grad":
                self.steps.append({})
            if name == "psum" and args[0].dim() != 2:   # the metrics' psums
                return orig(*args, **kw)
            e0, e1 = self._event(), self._event()
            e0.record()
            out = orig(*args, **kw)
            e1.record()
            self.steps[-1].setdefault(stage, []).append((e0, e1))
            return out

        return run

    def reset(self):
        self.steps = []

    def stage_ms(self) -> dict:
        """Per stage, the ms of each step that ran it (calls of one stage
        in a step summed)."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict = {}
        for step in self.steps:
            for stage, evs in step.items():
                out.setdefault(stage, []).append(
                    sum(a.elapsed_time(b) for a, b in evs))
        return out
