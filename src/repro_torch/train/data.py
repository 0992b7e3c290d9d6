"""Synthetic deterministic data pipeline with host-side prefetch — the
reference's ``repro/train/data.py`` as it is (it imports only numpy), so
both packages draw byte-equal batches.

Produces next-token-prediction batches: tokens (b, s+1) drawn from a
per-step-seeded PRNG (reproducible across restarts — the loader is keyed by
(seed, step) so resuming from a checkpoint replays the exact stream).
Modality stubs (whisper frames / vlm patches) are generated at the stated
shapes.  A background thread keeps `prefetch` batches ahead of the train
loop — the straggler-mitigation hook for input-bound steps.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    """pattern: "random" (entropy-floor stream) or "arith" (t_{i+1} =
    (t_i + stride) mod vocab — learnable, used by convergence tests)."""

    def __init__(self, cfg, seq: int, batch: int, *, seed: int = 0,
                 pattern: str = "random"):
        self.cfg, self.seq, self.batch, self.seed = cfg, seq, batch, seed
        self.pattern = pattern

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        if self.pattern == "arith":
            start = rng.integers(0, self.cfg.vocab, size=(self.batch, 1))
            stride = rng.integers(1, 5, size=(self.batch, 1))
            idx = np.arange(self.seq + 1)[None, :]
            toks = ((start + stride * idx) % self.cfg.vocab).astype(np.int32)
            out = {"tokens": toks}
        else:
            out = {
                "tokens": rng.integers(
                    0, self.cfg.vocab, size=(self.batch, self.seq + 1),
                    dtype=np.int32,
                )
            }
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (self.batch, self.cfg.n_patches, self.cfg.d_model)
            ).astype(np.float32)
        if self.cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.enc_frames, self.cfg.d_model)
            ).astype(np.float32)
        return out


class Prefetcher:
    """Background-thread prefetch of a step-indexed loader."""

    def __init__(self, loader, start_step: int = 0, depth: int = 2):
        self.loader = loader
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            batch = self.loader.batch_at(s)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
