"""Profiler capture windows for the drivers (a start step and a step count
on the command line, one trace artifact per run), over ``torch.profiler``.
Shared by ``launch/train.py`` (``--profile-start-step/--profile-steps``) and
``launch/serve.py`` (the same flags; a "step" is one driver tick or
offline loop iteration).
"""
from __future__ import annotations

import os
import time

import torch

__all__ = ["ProfilerWindow"]


class ProfilerWindow:
    """Capture steps ``[start, start + n)`` of a driver loop.

    Call ``step()`` once at the top of every driver iteration; the window
    starts and stops ``torch.profiler`` around the configured slice and
    ``close()`` (always call it — a crashed run must not leave the profiler
    armed) stops a still-open trace.  Disabled entirely when ``start < 0``
    or ``n < 1``, so drivers can construct one unconditionally.  The
    artifact is one Chrome trace (``trace_<pid>_<ms>.json``) under
    ``<outdir>/profile_<label>/``; CPU activity always, CUDA activity too
    when ``device`` is a CUDA device.
    """

    def __init__(self, start: int, n: int, outdir: str, label: str = "run",
                 *, device):
        self.enabled = start >= 0 and n >= 1
        self.start, self.n = int(start), int(n)
        self.logdir = os.path.join(outdir, f"profile_{label}")
        self.artifact: str | None = None
        self.captured = 0
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = None
        self._step = 0
        self._done = False

    def step(self) -> None:
        if not self.enabled or self._done:
            return
        if self._prof is None and self._step == self.start:
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=self.activities)
            self._prof.__enter__()
            self.artifact = self.logdir
        elif self._prof is not None:
            self.captured += 1
            if self.captured >= self.n:
                self._stop()
        self._step += 1

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            self.logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
        self._done = True

    def close(self) -> None:
        """Stop a still-open capture (loop ended inside the window)."""
        if self._prof is not None:
            self._stop()
