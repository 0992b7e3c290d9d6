"""The crypto half of the reference's continuous-batching serve engine
(``src/repro/serve/batcher.py``), as ``CryptoEngine``.

The reference's ``ContinuousBatcher`` serves two request families under one
tick clock: LLM decode and the big-integer crypto lane (DESIGN.md §15).
This module ports the crypto lane alone; the serve slice's
``ContinuousBatcher`` will hold a ``CryptoEngine`` and forward its crypto
calls to it.  The attribute names (``crypto``, ``crypto_ctx``,
``crypto_state``, ``wire``, ``verify_log``) are the reference's, so that
callers read both alike.

Per tick, every RUN slot advances ``crypto_chunk`` ladder bits in one call
of the lane's ``step`` (``crypto_chunk`` ladder-kernel launches on the
card); ``modmul``/``divmod`` run one-shot at admission.  ``rns_verify=True``
arms the RRNS integrity path: at admission each modexp slot's immutable
rows are fingerprinted and encoded through a locate-and-correct
``GradCodec`` into a channel-major ``RnsArray`` wire buffer held in a
``dist.fault.WireStore`` under ``("crypto", rid)``; at retirement the
fingerprint is recomputed from the rows that fed the ladder and compared
bitwise.  ``wire_ok`` detects a corrupted stored buffer and ``repair_wire``
rebuilds the bad channel in place.

>>> from repro_torch.serve.batcher import CryptoEngine
>>> from repro_torch.serve.crypto import CryptoContext, CryptoRequest
>>> eng = CryptoEngine(crypto_slots=2, crypto_chunk=4, rns_verify=True,
...                    crypto_ctx=CryptoContext(n_limbs=3, exp_bits=8),
...                    device="cpu")
>>> eng.submit(CryptoRequest(rid=0, op="modexp", a=7, b=200, n=1000003))
>>> eng.submit(CryptoRequest(rid=1, op="modmul", a=7, b=200, n=1000003))
>>> sorted((r.rid, r.result) for r in eng.run_to_completion())
[(0, 415475), (1, 1400)]
>>> eng.verify_log
{1: True, 0: True}
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.array import _device
from .crypto import (CryptoContext, CryptoLane, encode_exponent,
                     make_crypto_fns)
from .serve_step import crypto_state_zeros

__all__ = ["CryptoEngine"]


class CryptoEngine:
    """Slot-based continuous batching of crypto requests on one device.

    Parameters
    ----------
    crypto_slots : lane slots (>= 1): modexps resident at once.
    crypto_ctx : the lane's ``CryptoContext`` (default ``CryptoContext()``).
    crypto_chunk : ladder bits per tick (divides ``exp_bits``).
    rns_verify : arm the per-slot RRNS fingerprints.
    device : where the lane's state lives (default ``"cuda"``, which raises
        without a card).
    """

    def __init__(self, *, crypto_slots: int, crypto_ctx=None,
                 crypto_chunk: int = 8, rns_verify: bool = False,
                 device="cuda"):
        if not crypto_slots and crypto_ctx is not None:
            raise ValueError("crypto_ctx= given but crypto_slots=0; pass "
                             "crypto_slots>=1 to enable the crypto lane")
        self.device = _device(device)
        self.rns_verify = bool(rns_verify)
        if rns_verify:
            from ..dist.fault import WireStore
            from ..dist.grad_codec import GradCodec

            # world=1: fingerprints are fresh encodings, wraps=0 repairs
            self.codec = GradCodec.make(world=1, correct=True)
            self.wire = WireStore(self.codec)
            self.verify_log: dict = {}
        self.crypto_ctx = (crypto_ctx if crypto_ctx is not None
                           else CryptoContext())
        self.crypto = CryptoLane(int(crypto_slots), self.crypto_ctx.exp_bits,
                                 int(crypto_chunk))
        self.crypto_state = crypto_state_zeros(
            self.crypto_ctx, int(crypto_slots), self.device)
        self._crypto_fns = make_crypto_fns(self.crypto_ctx, int(crypto_chunk))

    # ------------------------------------------------------------ requests
    def _rid_held(self, rid) -> bool:
        """Is ``rid``'s verify state still live (queued, in flight, or
        retired and not yet drained)?"""
        lane = self.crypto
        return (rid in self.verify_log
                or any(q.rid == rid for q in lane.queue)
                or any(s.req is not None and s.req.rid == rid
                       for s in lane.slots)
                or ("crypto", rid) in self.wire)

    def submit(self, req) -> None:
        """Queue one crypto-family request (validated on the host)."""
        family = getattr(req, "family", "llm")
        if family == "llm":
            raise ValueError("llm-family requests need the ContinuousBatcher "
                             "of the serve slice; this engine serves the "
                             "'crypto' family")
        if family != "crypto":
            raise ValueError(f"unknown request family {family!r}; "
                             f"expected 'llm' or 'crypto'")
        self.crypto_ctx.validate(req)
        if self.rns_verify and self._rid_held(req.rid):
            # verify state is keyed on rid; refuse the collision
            # before any slot is bound or device work runs
            raise ValueError(
                f"rid {req.rid} already holds verify state (queued, in "
                f"flight, or retired-undrained); use unique rids, or "
                f"drain_completed() between reuses"
            )
        self.crypto.queue.append(req)

    def try_admit(self, now: float = 0.0) -> None:
        """Admit queued requests (see ``_crypto_admit``)."""
        self._crypto_admit(now)

    # --------------------------------------------------------- crypto lane
    def _crypto_row(self, v):
        return torch.from_numpy(np.asarray(v)).to(self.device)[None, :]

    def _crypto_admit(self, now: float) -> None:
        """Drain the crypto queue: one-shots (modmul/divmod) execute and
        retire inside this call; modexp binds a FREE lane slot and writes
        its ladder state (publishing the slot fingerprint when
        ``rns_verify`` is armed).  Stops when a modexp finds no free slot
        — FIFO order is preserved within the family."""
        lane = self.crypto
        while lane.queue:
            req = lane.queue[0]
            if req.op == "modexp":
                slot = lane.free_slot()
                if slot is None:
                    return
                lane.queue.popleft()
                self._crypto_bind(slot, req, now)
            else:
                lane.queue.popleft()
                req.t_admit = now
                req.result = (self._crypto_divmod(req)
                              if req.op == "divmod"
                              else self._crypto_modmul(req))
                req.t_done = now
                lane.completed.append(req)
                if self.rns_verify:
                    # one-shots hold no resident device state to corrupt;
                    # log them verified so rid accounting stays uniform
                    self.verify_log[req.rid] = True

    def _crypto_bind(self, slot, req, now: float) -> None:
        ctx, row = self.crypto_ctx, self._crypto_row
        c = ctx.consts_for(req.n)
        a = req.a % req.n
        self.crypto_state = self._crypto_fns["admit"](
            self.crypto_state, slot.index,
            row(ctx.encode_lo(a)), row(ctx.encode_hi(a)),
            row(c["m2_lo"]), row(c["m2_hi"]),
            row(c["one_lo"]), row(c["one_hi"]),
            row(c["neg"]), row(c["n_lo"]), row(c["n_hi"]),
            row(encode_exponent(ctx, req.b)),
        )
        self.crypto.bind(slot, req, now)
        if self.rns_verify:
            fp = self._crypto_fns["fp"](self.crypto_state, slot.index)
            self.wire.put(("crypto", req.rid),
                          self.codec.encode_array(fp, channel_major=True))

    def _crypto_modmul(self, req) -> int:
        ctx, row = self.crypto_ctx, self._crypto_row
        c = ctx.consts_for(req.n)
        a, b = req.a % req.n, req.b % req.n
        out = self._crypto_fns["modmul"](
            row(ctx.encode_lo(a)), row(ctx.encode_hi(a)),
            row(ctx.encode_lo(b)), row(ctx.encode_hi(b)),
            row(c["m2_lo"]), row(c["m2_hi"]),
            row(c["neg"]), row(c["n_hi"]), row(c["n_lo"]),
        )
        return ctx.decode_lo(out[0])

    def _crypto_divmod(self, req) -> tuple:
        ctx, row = self.crypto_ctx, self._crypto_row
        # Alg.-1 packed layout: base channels + m_a (RRNS contexts just
        # drop their extra m_b channel here — divmod runs on (n+1) rows)
        xp = row(ctx.encode_lo(req.a)[: ctx.n + 1])
        dp = row(ctx.encode_lo(req.b)[: ctx.n + 1])
        q, r = self._crypto_fns["divmod"](xp, dp)
        return ctx.decode_lo(q[0]), ctx.decode_lo(r[0])

    def _crypto_step(self, now: float) -> list:
        """Advance every RUN lane slot ``crypto_chunk`` ladder bits and
        retire the slots whose cursor reaches ``exp_bits``."""
        lane = self.crypto
        running = lane.running_slots()
        if not running:
            return []
        cursors = torch.tensor([s.cursor for s in lane.slots],
                               dtype=torch.int32, device=self.device)
        active = torch.tensor([1 if s.state == "RUN" else 0
                               for s in lane.slots],
                              dtype=torch.int32, device=self.device)
        self.crypto_state = self._crypto_fns["step"](
            self.crypto_state, cursors, active)
        retired = []
        for slot in running:
            slot.cursor += lane.chunk
            if slot.cursor >= lane.exp_bits:
                retired.append(self._crypto_retire(slot, now))
        return retired

    def _crypto_retire(self, slot, now: float):
        """Exit the Montgomery domain, decode the canonical result to a
        Python int, and verify the slot fingerprint against the wire
        codeword published at admission."""
        req = slot.req
        out = self._crypto_fns["final"](self.crypto_state, slot.index)
        req.result = self.crypto_ctx.decode_lo(out[0])
        if self.rns_verify:
            self.verify_log[req.rid] = self.verify_request(req)
        return self.crypto.retire(slot, now)

    # --------------------------------------------------------- the loop
    def step(self, now: float = 0.0) -> list:
        """One ``crypto_chunk``-bit ladder advance of the lane; returns the
        requests that retired this step."""
        return self._crypto_step(now)

    @property
    def busy(self) -> bool:
        """Work anywhere in the lane: queue or RUN slots."""
        return self.crypto.busy

    def run_to_completion(self, max_steps: int = 1 << 20) -> list:
        """Drain queue and slots (all arrivals already submitted)."""
        steps = 0
        while self.busy:
            self.try_admit(float(steps))
            if self.crypto.running_slots():
                self.step(float(steps))
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serve loop exceeded max_steps")
        return list(self.crypto.completed)

    def drain_completed(self) -> list:
        """Hand back the retired requests and release the engine-held
        state keyed on them (wire buffers, verify entries).  A long-lived
        server calls this after reading each batch of results."""
        done, self.crypto.completed = self.crypto.completed, []
        if self.rns_verify:
            for r in done:
                self.wire.pop(("crypto", r.rid), None)
                self.verify_log.pop(r.rid, None)
        return done

    # ------------------------------------------------------ RNS integrity
    def _require_verify(self):
        if not self.rns_verify:
            raise RuntimeError("engine built without rns_verify=True")

    def verify_request(self, req) -> bool:
        """Recompute the fingerprint of ``req``'s lane slot's immutable
        device rows (exponent bits + modulus channel constants) and compare
        its RNS encoding bitwise against the ``("crypto", rid)`` codeword
        published at admission.  Valid until the slot is reused by a later
        admission; the engine calls this automatically at retirement."""
        self._require_verify()
        fp = self._crypto_fns["fp"](self.crypto_state, req.slot_index)
        fresh = self.codec.encode_array(fp, channel_major=True)
        return self.wire.matches(("crypto", req.rid), fresh)

    def wire_ok(self, key) -> bool:
        """Codeword self-consistency of one stored wire buffer (RRNS
        redundant-channel check) — detects corruption of the stored
        fingerprint itself, without touching the lane state."""
        self._require_verify()
        return self.wire.ok(key)

    def repair_wire(self, key) -> dict:
        """Locate-and-correct one stored wire buffer in place via
        ``dist.fault.repair_packed``; returns its report dict."""
        self._require_verify()
        return self.wire.repair(key)

    def corrupt_wire(self, key, channel: int = 0, delta: int = 1,
                     index: int = 0) -> None:
        """Fault injection for tests and the serve CLI: modular-bump one
        residue of a stored wire buffer (stays a syntactically valid residue
        so the corruption is only catchable by the redundant channels)."""
        self._require_verify()
        self.wire.corrupt(key, channel=channel, delta=delta, index=index)
