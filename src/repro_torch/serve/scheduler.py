"""Slot scheduler for the continuous-batching serve engine (the reference's
DESIGN.md §12) and the paged-pool extension on top of it (DESIGN.md §13),
ported from ``repro/serve/scheduler.py``: the same fields, transitions,
action dicts, counters and errors, so both packages' schedulers driven by one
operation sequence hold equal tables, refcounts and ``page_stats``.

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
from collections import OrderedDict, deque

__all__ = [
    "FREE", "PREFILL", "DECODE", "Request", "Slot", "SlotScheduler",
    "PageAllocator", "PrefixRegistry", "PagedScheduler",
]

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


# ======================================================================
# Paged pool (DESIGN.md §13): allocator, prefix registry, paged scheduler
# ======================================================================
class PageAllocator:
    """Physical-page pool bookkeeping: free list, refcounts, reservations,
    and an LRU set of RETAINED pages (refcount 0 but still holding a
    registered, shareable prefix — evicted only under pressure).

    Page 0 is the PARKING page: every unmapped page-table entry points at
    it, idle decode rows scatter their junk into it, and it is never
    allocated — so pool traffic can never corrupt a mapped page.

    Page lifecycle::

        FREE ──alloc()──> ACTIVE (refcount >= 1) ──deref() to 0──┐
          ^                      ^                               │
          │                      └──── ref() revival ──── RETAINED (LRU)
          └───── deref(retain=False) ────┘      alloc() eviction ──> ACTIVE

    >>> al = PageAllocator(5)
    >>> al.alloc(), al.alloc()          # lowest free pids first, no evict
    ((1, False), (2, False))
    >>> al.ref(1); al.deref(1, retain=True)   # still shared
    'shared'
    >>> al.deref(1, retain=True)        # refcount 0 + registered -> LRU
    'retained'
    >>> al.deref(2, retain=False)
    'freed'
    >>> [al.alloc() for _ in range(2)]  # free pids 2,3 before evicting 1
    [(2, False), (3, False)]
    >>> al.alloc()
    (4, False)
    >>> al.alloc()                      # pool dry: evict LRU-retained 1
    (1, True)
    >>> al.in_use                       # all 4 non-parking pages live
    4
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("page pool needs >= 2 pages (one is parking)")
        self.n_pages = n_pages
        self.free: list[int] = list(range(n_pages - 1, 0, -1))  # pop -> 1
        self.refcount = [0] * n_pages
        self.retained: OrderedDict[int, None] = OrderedDict()  # LRU order
        self.reserved = 0
        self.stats = {"allocated": 0, "freed": 0, "evicted": 0,
                      "peak_in_use": 0}

    # ------------------------------------------------------------ queries
    @property
    def in_use(self) -> int:
        """Pages holding live (refcounted) data."""
        return self.n_pages - 1 - len(self.free) - len(self.retained)

    @property
    def available(self) -> int:
        """Pages an alloc() could hand out: free + evictable-retained."""
        return len(self.free) + len(self.retained)

    def is_retained(self, pid: int) -> bool:
        return pid in self.retained

    def can_reserve(self, n: int) -> bool:
        return n <= self.available - self.reserved

    def reserve(self, n: int) -> None:
        self.reserved += n

    def unreserve(self, n: int) -> None:
        self.reserved -= n
        assert self.reserved >= 0, "reservation underflow"

    # -------------------------------------------------------- transitions
    def alloc(self) -> tuple[int, bool]:
        """One exclusively-owned page: ``(pid, evicted)``.  Prefers the
        free list; under pressure evicts the LRU retained page (the caller
        must then drop that page's registry/fingerprint state — its
        CONTENT stays intact until the next device write to it)."""
        if self.free:
            pid, evicted = self.free.pop(), False
        elif self.retained:
            pid, _ = self.retained.popitem(last=False)
            evicted = True
            self.stats["evicted"] += 1
        else:
            raise RuntimeError(
                "page pool exhausted despite reservation gating (bug)"
            )
        self.refcount[pid] = 1
        self.stats["allocated"] += 1
        self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                        self.in_use)
        return pid, evicted

    def ref(self, pid: int) -> None:
        """Add a reader.  Reviving a retained page pulls it back out of
        the evictable set (its registry entry never went away)."""
        if pid in self.retained:
            del self.retained[pid]
            self.stats["peak_in_use"] = max(self.stats["peak_in_use"],
                                            self.in_use + 1)
        self.refcount[pid] += 1

    def adopt_retained(self, pid: int) -> None:
        """Warm-restart seeding (DESIGN.md §14): move a FREE page straight
        into the retained LRU set, as if a previous process had published
        and released it.  Only legal on a pristine pool — the caller
        (batcher.load_warm_state) restores page CONTENT separately.

        >>> al = PageAllocator(4)
        >>> al.adopt_retained(2); al.is_retained(2), al.available
        (True, 3)
        >>> al.alloc(), al.alloc(), al.alloc()   # 2 evicts last, LRU order
        ((1, False), (3, False), (2, True))
        """
        if self.refcount[pid] != 0 or pid not in self.free:
            raise ValueError(f"page {pid} is not free — cannot adopt")
        self.free.remove(pid)
        self.retained[pid] = None

    def deref(self, pid: int, *, retain: bool) -> str:
        """Drop a reader; returns the page's disposition — ``'shared'``
        (readers remain), ``'retained'`` (refcount 0 but registered: parked
        in the LRU evictable set, content + fingerprint still live), or
        ``'freed'`` (returned to the free list; content is dead)."""
        assert self.refcount[pid] > 0, f"deref of unreferenced page {pid}"
        self.refcount[pid] -= 1
        if self.refcount[pid] > 0:
            return "shared"
        if retain:
            self.retained[pid] = None
            return "retained"
        self.free.append(pid)
        self.stats["freed"] += 1
        return "freed"


class PrefixRegistry:
    """Content-addressed chains of immutable, fully-prompt-covered pages.

    A node maps ``(parent_pid | None, page_tokens)`` to the physical page
    holding that page of KV — so a chain walk from the root deduplicates
    any shared prompt PREFIX, not just exact prompt matches.  Only pages
    fully covered by a prompt are ever registered (partial tail pages keep
    getting decode writes and stay private), which is what makes
    registered pages immutable and safe to share.

    Dropping an evicted page takes its ENTIRE descendant subtree with it:
    child keys name the parent's physical pid, so if an orphaned chain
    survived and that pid were later re-allocated and re-registered for
    different content, ``match`` would walk straight through the reused
    pid into the stale chain and hand out pages whose KV was computed
    under a different prefix.  Subtree-dropped descendants keep their
    pool/fingerprint state (they stay in the allocator's retained set
    until evicted through the normal verify path) — only their
    reachability dies here.

    >>> reg = PrefixRegistry(page_size=2)
    >>> reg.add(None, (5, 6), pid=3); reg.add(3, (7, 8), pid=4)
    >>> reg.match([5, 6, 7, 8, 9])       # walks the chain, full pages only
    [3, 4]
    >>> reg.match([5, 6, 1, 2])          # diverges after one page
    [3]
    >>> reg.drop(3); reg.match([5, 6, 7, 8])   # parent evicted: no match
    []
    >>> 4 in reg.by_pid                  # descendant chain died with it
    False
    >>> reg.add(None, (9, 9), pid=3)     # pid 3 reused for NEW content
    >>> reg.match([9, 9, 7, 8])          # cannot resurrect the old chain
    [3]
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.nodes: dict[tuple, int] = {}
        self.by_pid: dict[int, tuple] = {}
        self.children: dict[int | None, set[int]] = {}

    def match(self, prompt: list) -> list[int]:
        """Physical pages of the longest registered chain covering the
        leading FULL pages of ``prompt`` (order = logical page order)."""
        out: list[int] = []
        key = None
        ps = self.page_size
        for j in range(len(prompt) // ps):
            toks = tuple(prompt[j * ps:(j + 1) * ps])
            pid = self.nodes.get((key, toks))
            if pid is None:
                break
            out.append(pid)
            key = pid
        return out

    def add(self, parent_key, toks: tuple, pid: int) -> None:
        self.nodes[(parent_key, toks)] = pid
        self.by_pid[pid] = (parent_key, toks)
        self.children.setdefault(parent_key, set()).add(pid)

    def drop(self, pid: int) -> None:
        """Unregister ``pid`` AND its whole descendant subtree (children
        are keyed by the raw parent pid, which the pool may reuse)."""
        stack = [pid]
        while stack:
            p = stack.pop()
            node_key = self.by_pid.pop(p, None)
            if node_key is None:
                continue
            self.nodes.pop(node_key, None)
            siblings = self.children.get(node_key[0])
            if siblings is not None:
                siblings.discard(p)
                if not siblings:
                    del self.children[node_key[0]]
            stack.extend(self.children.get(p, ()))


class PagedScheduler(SlotScheduler):
    """Slot scheduler over a PAGED physical pool (DESIGN.md §13).

    Extends the FREE/PREFILL/DECODE machine with the page-table layer: a
    host-side ``(n_slots, n_pg)`` int32 table maps each slot's logical
    pages to physical pages of the pooled cache buffer, and admission
    deduplicates shared prompt prefixes through ``PrefixRegistry`` —
    shared pages are refcounted read-only; the first write into one
    (divergence mid-page) triggers a copy-on-write.

    Division of labor with the engine: THIS class owns every host decision
    (which pages back which positions, when to copy, evict, or free) and
    reports device work as action dicts; serve/batcher.py executes them
    (page copies, fingerprint verification) and owns all device arrays.

    Admission gating is a capacity check in PAGES, not slots: a request
    reserves its worst-case exclusive page count up front and stays queued
    while the pool can't cover it, so max in-flight requests is bounded by
    the page pool even with free slot rows available.
    """

    def __init__(self, n_slots: int, cache_len: int, *, page_size: int,
                 n_pages: int, prefill_chunk: int,
                 prefix_share: bool = True, prefill_buckets=None):
        super().__init__(n_slots, cache_len)
        assert cache_len % page_size == 0
        self.page_size = page_size
        self.n_pg = cache_len // page_size
        self.prefill_chunk = prefill_chunk
        # the engine's (validated, sorted) bucket ladder, or None: the
        # scheduler must reserve by the SAME bucketed-vs-chunk rule the
        # engine dispatches by, or admission gating and the write barrier
        # disagree about the scratch page
        self.prefill_buckets = (tuple(prefill_buckets)
                                if prefill_buckets else None)
        # numpy-free on purpose: plain host ints; the engine snapshots the
        # table into a device array each step (data, never a trace const)
        self.table = [[0] * self.n_pg for _ in range(n_slots)]
        self.alloc = PageAllocator(n_pages)
        self.registry = PrefixRegistry(page_size) if prefix_share else None
        self.stats = {"dedup_hits": 0, "cow_copies": 0, "deferrals": 0}

    # ------------------------------------------------------------ queries
    def slot_pages(self, slot_index: int) -> list[tuple[int, int]]:
        """Mapped (logical_page, physical_page) pairs of one slot row."""
        return [(lp, pid) for lp, pid in enumerate(self.table[slot_index])
                if pid != 0]

    # ---------------------------------------------------------- admission
    def bucket_for(self, n: int):
        """Smallest configured bucket covering an ``n``-token extend, or
        None (no ladder / over-bucket fallback to the chunk loop)."""
        if self.prefill_buckets is None:
            return None
        for b in self.prefill_buckets:
            if b >= n:
                return b
        return None

    def _plan_admission(self, prompt: list, max_new: int):
        """Pure planning for the queue head: (pages to map from the
        registry, first position prefill must compute, worst-case pages to
        reserve).  ``prefill_start`` is chunk-aligned and always leaves at
        least the last prompt position to recompute, so first-token logits
        exist even on a full-prefix hit.

        Reservation sizing is path-dependent (DESIGN.md §13): the chunk
        loop writes its chunk-grid pads THROUGH the table, so it reserves
        up to ``pad_end``; the bucketed path routes every pad into a
        scratch page instead, so it reserves only the real span PLUS one
        page for the scratch itself."""
        ps, C = self.page_size, self.prefill_chunk
        plen = len(prompt)
        matched = self.registry.match(prompt) if self.registry else []
        shared_cap = min(len(matched) * ps, plen - 1)
        prefill_start = (shared_cap // C) * C
        # pages that provide content below prefill_start are worth mapping;
        # anything fully recomputed is cheaper to fill fresh than to copy
        m_map = min(len(matched), -(-prefill_start // ps))
        if self.bucket_for(plen - prefill_start) is not None:
            span_end = plen + max_new - 1
            n_reserve = -(-span_end // ps) - prefill_start // ps + 1
        else:
            pad_end = prefill_start + -(-(plen - prefill_start) // C) * C
            span_end = max(plen + max_new - 1, pad_end)
            n_reserve = -(-span_end // ps) - prefill_start // ps
        return matched[:m_map], prefill_start, n_reserve

    def admit_next(self, now: float = 0.0) -> Slot | None:
        """Like ``SlotScheduler.admit_next`` plus page planning: map the
        registered shared prefix into the slot's table row (refcounted)
        and reserve the worst-case exclusive pages.  A request whose
        reservation the pool can't cover DEFERS (stays at the queue head)
        even when slot rows are free — capacity is pages, not slots."""
        free = self.free_slots()
        if not free or not self.queue:
            return None
        req = self.queue[0]
        prompt = [int(t) for t in req.prompt]
        mapped, prefill_start, n_reserve = self._plan_admission(
            prompt, req.max_new
        )
        # revived retained pages leave the evictable set, so they need
        # headroom on top of the reservation itself
        n_revive = sum(1 for pid in mapped if self.alloc.is_retained(pid))
        if not self.alloc.can_reserve(n_reserve + n_revive):
            self.stats["deferrals"] += 1
            return None
        self.queue.popleft()
        slot = free[0]
        slot.state, slot.req = PREFILL, req
        slot.next_pos, slot.last_token = 0, 0
        slot.prefill_start, slot.reserved_left = prefill_start, n_reserve
        req.slot_index, req.t_admit = slot.index, now
        for j, pid in enumerate(mapped):
            self.alloc.ref(pid)
            self.table[slot.index][j] = pid
            self.stats["dedup_hits"] += 1
        self.alloc.reserve(n_reserve)
        return slot

    # ------------------------------------------------------ write barrier
    def _alloc_for(self, slot: Slot, actions: list) -> int:
        if slot.reserved_left <= 0:
            raise RuntimeError(
                f"slot {slot.index}: write past its page reservation "
                f"(engine bug)"
            )
        pid, evicted = self.alloc.alloc()
        if evicted:
            # a retained shareable page got recycled: its registry entry
            # AND its descendant chain die now (the reused pid must never
            # resurrect them); the engine verifies + drops its fingerprint
            # when it executes this action (content is still intact)
            if self.registry is not None:
                self.registry.drop(pid)
            actions.append({"op": "evict", "pid": pid})
        slot.reserved_left -= 1
        self.alloc.unreserve(1)
        return pid

    def plan_write(self, slot: Slot, start: int, n: int) -> list[dict]:
        """Host write barrier: make logical positions [start, start+n) of
        ``slot`` writable — every touched page mapped, exclusively owned,
        and unregistered.  Returns the device actions the engine must
        execute IN ORDER before the write lands:

          {"op": "evict", "pid": p}              verify+drop p's fingerprint
          {"op": "cow", "lp": l, "src": s, "dst": d}   copy page s -> d
          {"op": "alloc", "lp": l, "pid": p}     informational (fresh page)

        Copy-on-write fires when a to-be-written page is shared (refcount
        > 1) OR registered (immutable while shareable, even at refcount 1
        — a later admission may still match it)."""
        actions: list[dict] = []
        ps = self.page_size
        row = self.table[slot.index]
        for lp in range(start // ps, (start + n - 1) // ps + 1):
            pid = row[lp]
            if pid == 0:
                new = self._alloc_for(slot, actions)
                row[lp] = new
                actions.append({"op": "alloc", "lp": lp, "pid": new})
                continue
            registered = (self.registry is not None
                          and pid in self.registry.by_pid)
            if self.alloc.refcount[pid] > 1 or registered:
                new = self._alloc_for(slot, actions)  # src is refd: safe
                row[lp] = new
                self.alloc.deref(pid, retain=registered)
                actions.append({"op": "cow", "lp": lp, "src": pid,
                                "dst": new})
                self.stats["cow_copies"] += 1
        return actions

    def alloc_scratch(self, slot: Slot) -> tuple[int, list[dict]]:
        """Take one page from ``slot``'s reservation as the pad sink for a
        bucketed prefill call.  The scratch page is NEVER entered in the
        table, never registered, and never fingerprinted — it exists only
        so the padded write barrier has a physical page to absorb pad
        scatters (DESIGN.md §13).  May evict a retained page (the returned
        actions must be executed before the extend call).  The caller MUST
        ``free_scratch`` it right after the extend lands."""
        actions: list[dict] = []
        pid = self._alloc_for(slot, actions)
        return pid, actions

    def free_scratch(self, pid: int) -> None:
        """Return a scratch page to the free list.  Its pad content is
        garbage by construction; it must not be retained (a retained page
        is shareable, and scratch content must never become shareable)."""
        self.alloc.deref(pid, retain=False)

    # ------------------------------------------------------- registration
    def register_prompt(self, slot: Slot, prompt: list) -> None:
        """After prefill: publish the slot's fully-prompt-covered pages as
        registry chain nodes so later admissions can share them.  Pages
        whose content already has a registered twin (this slot recomputed
        a known prefix) are skipped — first publisher wins."""
        if self.registry is None:
            return
        ps = self.page_size
        row = self.table[slot.index]
        key = None
        for j in range(len(prompt) // ps):
            toks = tuple(int(t) for t in prompt[j * ps:(j + 1) * ps])
            hit = self.registry.nodes.get((key, toks))
            if hit is not None:
                key = hit
                continue
            pid = row[j]
            if self.alloc.refcount[pid] != 1 or pid in self.registry.by_pid:
                break  # not exclusively ours to publish — stop the chain
            self.registry.add(key, toks, pid)
            key = pid

    # -------------------------------------------------------- retirement
    def release_pages(self, slot_index: int) -> list[tuple[int, str]]:
        """Page-granular free at retirement: deref every mapped page of
        the slot row and zero the row (back to parking).  Returns the
        (pid, disposition) transitions — ``'freed'`` pages are dead (the
        engine verifies + drops their fingerprints), ``'retained'`` pages
        stay shareable/evictable with live fingerprints, ``'shared'``
        pages still have readers.  The unused tail of the request's page
        reservation returns to the pool here too (early EOS)."""
        slot = self.slots[slot_index]
        self.alloc.unreserve(slot.reserved_left)
        slot.reserved_left, slot.prefill_start = 0, 0
        out = []
        row = self.table[slot_index]
        for lp in range(self.n_pg):
            pid = row[lp]
            if pid == 0:
                continue
            row[lp] = 0
            retain = (self.registry is not None
                      and pid in self.registry.by_pid)
            out.append((pid, self.alloc.deref(pid, retain=retain)))
        return out

    # ------------------------------------------------------ warm restart
    def adopt_page(self, pid: int, parent_key, toks: tuple) -> None:
        """Seed one revalidated page from a previous process's warm state:
        pool side becomes retained (evictable LRU), registry side becomes
        a chain node under ``parent_key`` — exactly the state the page
        held when the old process released it.  Parents must be adopted
        before children (chain keys name the parent's physical pid)."""
        if self.registry is None:
            raise RuntimeError("prefix sharing disabled: nothing to adopt")
        if parent_key is not None and parent_key not in self.registry.by_pid:
            raise ValueError(
                f"page {pid}: parent {parent_key} not adopted — restore "
                f"chains parents-first")
        self.alloc.adopt_retained(pid)
        self.registry.add(parent_key, tuple(toks), pid)

    # ------------------------------------------------------------- stats
    def page_stats(self) -> dict:
        """Pool/dedup counters for reports (launch/serve.py --report)."""
        return {
            "page_size": self.page_size,
            "n_pages": self.alloc.n_pages,
            "pages_in_use": self.alloc.in_use,
            "pages_retained": len(self.alloc.retained),
            "pages_in_use_peak": self.alloc.stats["peak_in_use"],
            "pages_allocated": self.alloc.stats["allocated"],
            "pages_freed": self.alloc.stats["freed"],
            "pages_evicted": self.alloc.stats["evicted"],
            "dedup_hits": self.stats["dedup_hits"],
            "cow_copies": self.stats["cow_copies"],
            "deferrals": self.stats["deferrals"],
        }
