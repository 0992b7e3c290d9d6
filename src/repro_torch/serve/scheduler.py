"""Slot scheduler for the continuous-batching serve engine (the reference's
DESIGN.md §12), ported from ``repro/serve/scheduler.py``: the same fields,
transitions and errors.  The paged-pool classes of the reference
(``PageAllocator``, ``PrefixRegistry``, ``PagedScheduler``) come with the
paged slice (ROADMAP.md, queue 1).

Pure host-side bookkeeping — no torch here.  The engine (serve/batcher.py)
owns the device arrays; this module owns the request queue and the per-slot
state machine that decides which row of the batched KV cache belongs to
which request at every decode step:

    FREE ──admit_next()──> PREFILL ──start_decode()──> DECODE
      ^                                                   │
      └────────── retirement (EOS / max_new) ─────────────┘

A ``Slot`` is one row of the batched cache (a fixed-capacity sequence of
``cache_len`` KV positions).  Admission binds a queued ``Request`` to a
FREE slot; the engine then chunk-prefills the prompt into that row and
calls ``start_decode`` with the first sampled token.  Every decode step
consumes ``step_rows()`` — the (token, position) vectors the persistent
decode step reads — and feeds each sampled token back through
``record_token``, which retires the slot (back to FREE, ready for reuse)
when the request hits its EOS token or its ``max_new`` budget.

Doctest — a 2-slot admission/retirement trace (the worked example of
DESIGN.md §12)::

    >>> from repro_torch.serve.scheduler import Request, SlotScheduler
    >>> sch = SlotScheduler(n_slots=2, cache_len=16)
    >>> sch.submit(Request(rid=0, prompt=[5, 6, 7], max_new=3))
    >>> sch.submit(Request(rid=1, prompt=[8, 9], max_new=2))
    >>> slot = sch.admit_next()
    >>> slot.index, slot.state
    (0, 'PREFILL')
    >>> sch.admit_next().index                  # second request -> slot 1
    1
    >>> sch.admit_next() is None                # no slots left
    True
    >>> sch.start_decode(slot, first_token=9)   # not yet retired
    False
    >>> slot.state, slot.next_pos, slot.last_token
    ('DECODE', 3, 9)
    >>> sch.start_decode(sch.slots[1], first_token=4)
    False
    >>> sch.step_rows()                         # (tokens, write positions)
    ([9, 4], [3, 2])
    >>> sch.record_token(slot, 11)              # token 2 of 3
    False
    >>> sch.record_token(sch.slots[1], 7)       # rid 1 hits max_new=2
    True
    >>> sch.slots[1].state                      # retired -> reusable
    'FREE'
    >>> sch.step_rows()                         # freed row parks at S-1
    ([11, 0], [3, 15])
    >>> sch.record_token(slot, 12)              # rid 0 hits max_new=3
    True
    >>> sorted((r.rid, r.out) for r in sch.completed)
    [(0, [9, 11, 12]), (1, [4, 7])]
"""
from __future__ import annotations

import dataclasses
from collections import deque

__all__ = ["FREE", "PREFILL", "DECODE", "Request", "Slot", "SlotScheduler"]

FREE = "FREE"
PREFILL = "PREFILL"
DECODE = "DECODE"


@dataclasses.dataclass
class Request:
    """One generation request plus its engine-filled result/latency fields.

    ``arrival`` and the ``t_*`` stamps are in the caller's clock (the serve
    driver uses decode-step ticks so reports are deterministic; wall time
    is recorded separately).
    """

    rid: int
    prompt: list
    max_new: int
    eos: int | None = None
    arrival: float = 0.0
    family: str = "llm"      # engine dispatch tag; crypto requests carry
    #                          "crypto" (serve/crypto.py CryptoRequest)
    # engine-filled:
    out: list = dataclasses.field(default_factory=list)
    slot_index: int | None = None
    t_admit: float | None = None
    t_first: float | None = None
    t_done: float | None = None


@dataclasses.dataclass
class Slot:
    """One row of the batched KV cache: state + decode cursor.

    ``next_pos`` is the cache position the NEXT decode step writes (the
    position of ``last_token``, which has been sampled but not yet run
    through the model).  The fields of an idle slot reset to (0, 0), but
    the device view (``step_rows``) parks idle rows at position
    ``cache_len - 1`` — the one position real traffic never writes — so
    their junk KV writes stay outside every read or fingerprinted span.
    """

    index: int
    state: str = FREE
    req: Request | None = None
    next_pos: int = 0
    last_token: int = 0
    # paged-pool extension (PagedScheduler; always 0 on the monolithic
    # path): first position the admission prefill actually computes (below
    # it the row reads shared prefix pages) and the not-yet-consumed page
    # reservation backing this request's future writes.
    prefill_start: int = 0
    reserved_left: int = 0


class SlotScheduler:
    """Admission/retirement over a fixed pool of ``n_slots`` cache rows."""

    def __init__(self, n_slots: int, cache_len: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.slots = [Slot(index=i) for i in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []

    # ------------------------------------------------------------ queries
    @property
    def pending(self) -> int:
        """Queued requests not yet admitted."""
        return len(self.queue)

    def free_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.state == FREE]

    def decoding_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.state == DECODE]

    @property
    def busy(self) -> bool:
        """True while any request is queued or in flight."""
        return bool(self.queue) or any(s.state != FREE for s in self.slots)

    # -------------------------------------------------------- transitions
    def submit(self, req: Request) -> None:
        """Queue a request (FIFO).  Capacity is checked here so a prompt
        that can never fit fails at submit time, not mid-stream."""
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        need = len(req.prompt) + req.max_new
        if need > self.cache_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {need} exceeds the "
                f"slot capacity cache_len = {self.cache_len}"
            )
        self.queue.append(req)

    def admit_next(self, now: float = 0.0) -> Slot | None:
        """Bind the oldest queued request to a FREE slot (FREE -> PREFILL);
        None when the queue is empty or every slot is occupied."""
        free = self.free_slots()
        if not free or not self.queue:
            return None
        slot, req = free[0], self.queue.popleft()
        slot.state, slot.req = PREFILL, req
        slot.next_pos, slot.last_token = 0, 0
        req.slot_index, req.t_admit = slot.index, now
        return slot

    def start_decode(self, slot: Slot, first_token: int,
                     now: float = 0.0) -> bool:
        """PREFILL -> DECODE once the prompt is in the cache row and the
        first token has been sampled from the last prompt position's
        logits.  Returns True if the request retired immediately (one-token
        budget or instant EOS)."""
        assert slot.state == PREFILL, slot.state
        slot.state = DECODE
        slot.next_pos = len(slot.req.prompt)
        slot.last_token = int(first_token)
        return self.record_token(slot, first_token, now)

    def record_token(self, slot: Slot, token: int, now: float = 0.0) -> bool:
        """Append a sampled token to the slot's request; retire the slot
        (DECODE -> FREE) and return True on EOS or exhausted ``max_new``."""
        assert slot.state == DECODE, slot.state
        req = slot.req
        req.out.append(int(token))
        if req.t_first is None:
            req.t_first = now
        slot.last_token = int(token)
        if len(req.out) >= req.max_new or (
            req.eos is not None and int(token) == req.eos
        ):
            req.t_done = now
            self.completed.append(req)
            slot.state, slot.req = FREE, None
            slot.next_pos, slot.last_token = 0, 0
            return True
        return False

    # ------------------------------------------------------- device views
    def step_rows(self) -> tuple[list, list]:
        """The (tokens, positions) rows one persistent decode step reads:
        DECODE slots contribute (last_token, next_pos); FREE/PREFILL rows
        park at (0, cache_len - 1).  The parking position is the one row
        position NO request ever writes — real traffic stops at position
        len(prompt) + max_new - 2 <= cache_len - 2 (the final sampled
        token is never written back) — so idle junk never lands inside a
        region anyone reads or fingerprints (DESIGN.md §12)."""
        park = self.cache_len - 1
        toks = [s.last_token if s.state == DECODE else 0 for s in self.slots]
        poss = [s.next_pos if s.state == DECODE else park
                for s in self.slots]
        return toks, poss

    def advance(self, slot: Slot) -> None:
        """Move a DECODE slot's write cursor past the token the decode step
        just committed to the cache."""
        assert slot.state == DECODE, slot.state
        slot.next_pos += 1
