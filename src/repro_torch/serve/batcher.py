"""The continuous-batching serve engine (``src/repro/serve/batcher.py``,
the reference's DESIGN.md §12 and §15): ``CryptoEngine``, the big-integer
crypto lane, and ``ContinuousBatcher``, the slot engine of the LLM lane (on
a batched cache or, with ``page_size=``, on a paged, prefix-sharing pool:
DESIGN.md §13), which holds a ``CryptoEngine`` when ``crypto_slots >= 1``
and forwards its crypto calls to it.  Both families then run under one tick clock and share
one wire store and one ``verify_log``.  The attribute names (``sched``,
``cache``, ``crypto``, ``crypto_ctx``, ``wire``, ``verify_log``) are the
reference's, so that callers read both alike.

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

import dataclasses

import numpy as np
import torch

from ..core.array import _device
from ..models import decode_step, extend_step
from .crypto import (CryptoContext, CryptoLane, encode_exponent,
                     make_crypto_fns)
from .scheduler import PagedScheduler, Request, Slot, SlotScheduler
from .serve_step import (Traced, cache_zeros, crypto_state_zeros,
                         paged_pool_zeros)

__all__ = ["CryptoEngine", "ContinuousBatcher"]


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
        self._crypto_fns = {
            name: Traced(fn) for name, fn in
            make_crypto_fns(self.crypto_ctx, int(crypto_chunk)).items()}

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
            raise ValueError("llm-family requests go to the "
                             "ContinuousBatcher of the serve slice; this "
                             "engine serves the 'crypto' family")
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

    def jit_cache_sizes(self) -> dict:
        """Argument signatures per lane function (``serve_step.Traced``),
        under the reference's report keys; every value stays 1."""
        names = ["admit", "step", "final", "modmul", "divmod"]
        if self.rns_verify:
            names.append("fp")
        return {("crypto_fingerprint" if name == "fp" else f"crypto_{name}"):
                self._crypto_fns[name]._cache_size() for name in names}

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


_SUPPORTED = ("dense", "moe")


class ContinuousBatcher:
    """Slot-based continuous batching over one batched decode cache.

    The batch axis of the decode cache is a pool of ``n_slots`` fixed-
    capacity rows ("slots"), each row belonging to at most one request.  New
    requests are admitted into FREE rows mid-decode: the engine
    chunk-prefills the prompt through ``extend_step`` on a one-row solo
    cache, splices the row into the pool, and the next decode step carries
    the newcomer along with every running stream.  The decode step takes
    per-row positions, so arrival and departure never change an argument's
    shape: ``jit_cache_sizes()`` reports one signature per engine function
    (``serve_step.Traced``).  Rows are computationally independent, so a
    request's tokens and KV row are bitwise the same alone or packed
    against any co-resident traffic.

    ``page_size=`` puts the engine on the PAGED pool (the reference's
    DESIGN.md §13): the cache is one pooled buffer of fixed-size pages, a
    host-side ``(n_slots, n_pg)`` page table (``PagedScheduler``) maps each
    slot's logical pages to physical ones, and admission deduplicates shared
    prompt prefixes.  Shared pages are refcounted and read-only; the first
    write into one copies it first (copy-on-write, ``_copy_impl``).  The
    table rides into the decode and extend calls as data (a tensor of fixed
    shape), and prompts prefill straight into the pool through it (no solo
    cache, no splice).

    ``rns_verify=True`` arms the RNS integrity path: at admission the engine
    fingerprints the slot's immutable prompt region (per-layer K/V sums) and
    encodes it through an RRNS ``GradCodec`` into a channel-major
    ``RnsArray`` wire buffer held in a ``dist.fault.WireStore`` under the
    request id — or, on the paged pool, under the PHYSICAL PAGE, so that one
    codeword covers every reader of a shared page and is checked when the
    page is freed or evicted (on a CUDA cache, through the codec_encode
    kernel).  Decode never writes below a slot's prompt length, so at
    retirement the recomputed fingerprint must match bitwise.  ``wire_ok``
    detects a corrupted stored buffer and ``repair_wire`` rebuilds the bad
    channel in place (``dist.fault.repair_packed``).

    Parameters
    ----------
    cfg, params : the model (the dense family; ``params`` on the device the
        engine runs on).  Sliding-window archs are lowered to the masked
        full-length cache layout (``window_cache=False``).
    n_slots : rows of the batched cache = max concurrent requests.
    cache_len : per-slot KV capacity; every request needs
        ``len(prompt) + max_new <= cache_len``.
    prefill_chunk : token-chunk size of the admission prefill loop.
    prefill_buckets : optional ascending prompt-length buckets: admission
        pads the prompt to the smallest bucket >= plen and runs one extend
        call instead of the chunk loop (longer prompts fall back to it).
        On the paged pool the bucket is chosen by the tokens left to compute
        after the shared prefix, and the pads go to a one-call scratch page
        (the padded write barrier).
    rns_verify : arm the RnsArray cache-integrity fingerprints.
    page_size : pages of this many tokens (must divide ``cache_len`` and
        align with ``prefill_chunk``); None (default) keeps the batched
        slot-row cache.
    n_pages : physical pages in the pool (paged only); default
        ``1 + n_slots * (cache_len // page_size)``: the parking page and
        full backing for every slot.  A smaller pool admits by pages.
    prefix_share : admission-time prompt-prefix dedup (paged only).
    crypto_slots, crypto_ctx, crypto_chunk : the crypto lane
        (``CryptoEngine``); 0 slots (default) disables the family.

    >>> from repro_torch.configs import get_config
    >>> from repro_torch.models import init_params
    >>> from repro_torch.serve.scheduler import Request
    >>> cfg = get_config("gemma-2b").smoke()
    >>> eng = ContinuousBatcher(cfg, init_params(cfg, 0, "cpu"),
    ...                         n_slots=2, cache_len=32, prefill_chunk=8)
    >>> eng.submit(Request(rid=0, prompt=[3, 1, 4, 1, 5], max_new=4))
    >>> [(r.rid, len(r.out)) for r in eng.run_to_completion()]
    [(0, 4)]
    >>> eng.jit_cache_sizes()["decode"]         # one argument signature
    1
    """

    def __init__(self, cfg, params, *, n_slots: int, cache_len: int,
                 prefill_chunk: int = 32,
                 prefill_buckets: tuple | None = None,
                 rns_verify: bool = False,
                 page_size: int | None = None,
                 n_pages: int | None = None, prefix_share: bool = True,
                 crypto_slots: int = 0, crypto_ctx=None,
                 crypto_chunk: int = 8):
        cfg.validate()
        if cfg.family not in _SUPPORTED:
            raise NotImplementedError(
                f"continuous batching needs a linear-KV transformer family "
                f"{_SUPPORTED}, not {cfg.family!r} (SSM/hybrid state and "
                f"encoder caches are not slot-spliceable yet)"
            )
        if cfg.kv_quant:
            raise NotImplementedError(
                "int8 KV slots need per-slot scale re-estimation at "
                "admission; run the batcher on the fp cache layout"
            )
        if cfg.window and cfg.window_cache:
            # grouped ring caches can't take per-row positions; the masked
            # full-length layout is semantically identical (more HBM)
            cfg = dataclasses.replace(cfg, window_cache=False)
        if cache_len > 512 and cache_len % 512:
            lo, hi = cache_len // 512 * 512, -(-cache_len // 512) * 512
            raise ValueError(
                f"cache_len={cache_len} beyond one flash chunk must be a "
                f"multiple of 512 (prefill eval_shape runs the chunked "
                f"attention); nearest legal cache_len: {lo} or {hi}"
            )
        divisors = [d for d in range(1, cache_len + 1) if cache_len % d == 0]
        if cache_len % prefill_chunk:
            # a prompt padded to the chunk grid could otherwise run past
            # the row, where the reference's update-slice clamp would
            # shift the write window backwards over earlier positions
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must divide "
                f"cache_len={cache_len}; valid prefill_chunk values: "
                f"{divisors}"
            )
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.prefill_chunk = C = int(prefill_chunk)
        self.rns_verify = bool(rns_verify)
        self.paged = page_size is not None
        self.page_size = int(page_size) if self.paged else None

        self.prefill_buckets: tuple[int, ...] | None = None
        if prefill_buckets is not None:
            bks = tuple(sorted({int(b) for b in prefill_buckets}))
            if not bks:
                raise ValueError("prefill_buckets must name >= 1 bucket")
            for b in bks:
                if b < 1 or b > cache_len:
                    raise ValueError(
                        f"bucket {b} out of range 1..cache_len={cache_len}"
                    )
                if b > 512 and b % 512:
                    raise ValueError(
                        f"bucket {b} beyond one flash chunk must be a "
                        f"multiple of 512 (the padded extend runs the "
                        f"chunked attention)"
                    )
            self.prefill_buckets = bks
            self.bucket_hits: dict[int, int] = {b: 0 for b in bks}
            self.bucket_fallbacks = 0
            self.bucket_pad_tokens = 0
            self.bucket_real_tokens = 0

        if self.paged:
            ps = self.page_size
            if cache_len % ps:
                raise ValueError(
                    f"page_size={ps} must divide cache_len={cache_len}; "
                    f"valid page sizes: {divisors}"
                )
            if ps % C and C % ps:
                # page-aligned or chunk-aligned prefill writes; anything
                # else makes every chunk straddle page ownership checks
                legal = [d for d in divisors if d % C == 0 or C % d == 0]
                raise ValueError(
                    f"page_size={ps} must align with prefill_chunk={C} "
                    f"(one must divide the other); chunk-compatible page "
                    f"sizes for cache_len={cache_len}: {legal}"
                )
            if ps > 512 and ps % 512:
                raise ValueError(
                    f"page_size={ps} beyond one flash chunk must be a "
                    f"multiple of 512 (the pool abstract runs the chunked "
                    f"prefill per page); nearest legal page_size: "
                    f"{ps // 512 * 512} or {-(-ps // 512) * 512}"
                )
            n_pg = cache_len // ps
            if n_pages is None:
                n_pages = 1 + n_slots * n_pg
            min_pages = n_pg + 2
            if n_pages < min_pages:
                raise ValueError(
                    f"n_pages={n_pages} cannot guarantee admission of one "
                    f"max-length request: cache_len={cache_len} / "
                    f"page_size={ps} = {n_pg} logical pages, plus the "
                    f"parking page and one page of mid-page-divergence "
                    f"headroom; minimum n_pages: {min_pages}"
                )
            self.n_pages = int(n_pages)
            self.sched = PagedScheduler(
                n_slots, cache_len, page_size=ps, n_pages=self.n_pages,
                prefill_chunk=C, prefix_share=prefix_share,
                prefill_buckets=self.prefill_buckets,
            )
            self._solo = None
            self.cache = paged_pool_zeros(cfg, self.n_pages, ps, self.device)
        else:
            self.sched = SlotScheduler(n_slots, cache_len)
            self._solo = cache_zeros(cfg, 1, cache_len, self.device)
            self.cache = cache_zeros(cfg, n_slots, cache_len, self.device)

        # The engine's functions; each keeps one argument signature for
        # the engine's lifetime (fixed shapes; slot ids, positions, page
        # ids and the page table's contents are data).
        if self.paged:
            psz = self.page_size
            # valid/scratch are the padded write barrier: the chunk loop
            # passes valid = chunk width (every token through the table,
            # chunk-grid pads included) and the parking page as a dead
            # scratch; bucketed prefill passes the real tokens and a live
            # scratch page.  Either way one signature per token width.
            self._extend_fn = Traced(
                lambda p, c, t, pos, idx, pg, valid, scr: extend_step(
                    cfg, p, c, t, pos, logit_index=idx, pages=pg,
                    page_size=psz, valid_len=valid, scratch=scr))
            self._decode_fn = Traced(self._decode_paged_impl)
            self._copy_fn = Traced(self._copy_impl)
            self._insert_fn = None
        else:
            self._extend_fn = Traced(
                lambda p, c, t, pos, idx: extend_step(cfg, p, c, t, pos,
                                                      logit_index=idx))
            self._decode_fn = Traced(self._decode_impl)
            self._insert_fn = Traced(self._insert_impl)
            self._copy_fn = None
        self._fp_fn = (Traced(self._fp_paged_impl if self.paged
                              else self._fp_impl)
                       if rns_verify else None)
        if rns_verify:
            from ..dist.fault import WireStore
            from ..dist.grad_codec import GradCodec

            # world=1: fingerprints are fresh encodings, wraps=0 repairs
            self.codec = GradCodec.make(world=1, correct=True)
            # keyed by rid (batched rows) / physical page (paged pool)
            self.wire = WireStore(self.codec)
            self._page_span: dict = {}
            # physical page -> rid whose prefill published its codeword, so
            # corruption found at EVICTION (no retiring request in hand)
            # still lands in verify_log under a request id
            self._page_pub: dict = {}
            self.verify_log: dict = {}

        # The crypto lane: a CryptoEngine on the same device, sharing this
        # engine's codec, wire store and verify log (its keys are
        # ("crypto", rid)).
        self._crypto = None
        if crypto_slots:
            self._crypto = CryptoEngine(
                crypto_slots=int(crypto_slots), crypto_ctx=crypto_ctx,
                crypto_chunk=int(crypto_chunk), rns_verify=rns_verify,
                device=self.device)
            if rns_verify:
                self._crypto.codec = self.codec
                self._crypto.wire = self.wire
                self._crypto.verify_log = self.verify_log
        elif crypto_ctx is not None:
            raise ValueError("crypto_ctx= given but crypto_slots=0; pass "
                             "crypto_slots>=1 to enable the crypto lane")

    # ------------------------------------------------- the crypto lane's view
    @property
    def crypto(self):
        """The crypto lane (``CryptoLane``), or None when disarmed."""
        return None if self._crypto is None else self._crypto.crypto

    @property
    def crypto_ctx(self):
        return None if self._crypto is None else self._crypto.crypto_ctx

    @property
    def _wire(self) -> dict:
        """Raw key -> RnsArray mapping of the wire store (rid-keyed on the
        batched cache, page-keyed on the paged pool)."""
        return self.wire.raw

    # ------------------------------------------------------ engine functions
    def _decode_impl(self, params, cache, tokens, pos):
        """One batched decode step + greedy sampling.  tokens: (B, 1),
        pos: (B,) per-slot write positions."""
        logits, cache = decode_step(self.cfg, params, cache, tokens, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    @torch.inference_mode()
    def _insert_impl(self, batch_cache, solo_cache, slot: int):
        """Splice a freshly prefilled solo cache (batch 1) into row ``slot``
        of the batched cache, in place (the "len" leaf is left alone)."""
        for name, leaf in batch_cache.items():
            if isinstance(leaf, torch.Tensor):
                leaf[:, slot] = solo_cache[name][:, 0].to(leaf.dtype)
        return batch_cache

    @torch.inference_mode()
    def _fp_impl(self, cache, slot: int, plen: int):
        """Per-layer masked K/V sums over row ``slot``'s immutable prompt
        region [0, plen) -> (2L,) f32 fingerprint vector."""
        S = cache["k"].shape[2]
        valid = (torch.arange(S, device=self.device) < plen).to(torch.float32)
        sums = [(cache[name][:, slot].to(torch.float32)
                 * valid[None, :, None, None]).sum(dim=(1, 2, 3))
                for name in ("k", "v")]
        return torch.cat(sums)

    # ------------------------------------------------- paged-pool functions
    def _decode_paged_impl(self, params, cache, tokens, pos, pages):
        """Paged twin of ``_decode_impl``: the (n_slots, n_pg) page table
        routes each row's token write and read gather
        (``attention.attn_decode_paged``)."""
        logits, cache = decode_step(self.cfg, params, cache, tokens, pos,
                                    pages=pages, page_size=self.page_size)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    @torch.inference_mode()
    def _copy_impl(self, cache, src: int, dst: int):
        """Copy physical page ``src`` over page ``dst`` on every pool leaf,
        in place — the device half of copy-on-write."""
        for leaf in cache.values():
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2:
                leaf[:, dst] = leaf[:, src]
        return cache

    @torch.inference_mode()
    def _fp_paged_impl(self, cache, pid: int, span: int):
        """Per-layer masked K/V sums over physical page ``pid``'s prompt
        span [0, span) -> (2L,) f32 fingerprint vector (the paged twin of
        ``_fp_impl``: one codeword per page, shared by all its readers)."""
        valid = (torch.arange(self.page_size, device=self.device)
                 < span).to(torch.float32)
        sums = [(cache[name][:, pid].to(torch.float32)
                 * valid[None, :, None, None]).sum(dim=(1, 2, 3))
                for name in ("k", "v")]
        return torch.cat(sums)

    def _table(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------ paged host glue
    def _page_codeword(self, pid: int):
        """Freshly recomputed RRNS codeword of page ``pid``'s stored prompt
        span."""
        fp = self._fp_fn(self.cache, pid, self._page_span[pid])
        return self.codec.encode_array(fp, channel_major=True)

    def _exec_actions(self, actions: list) -> None:
        """Execute a ``PagedScheduler.plan_write`` action list in order:
        evictions verify and drop the page's fingerprint (its content is
        still intact then), copy-on-write runs the page copy, fresh allocs
        need no device work.  An eviction-verify MISMATCH is recorded in
        ``verify_log`` under the page's publisher rid (and in the wire
        stats), not just counted."""
        for act in actions:
            if act["op"] == "evict":
                pid = act["pid"]
                if self.rns_verify and pid in self.wire:
                    ok = self.wire.matches(pid, self._page_codeword(pid))
                    pub = self._page_pub.pop(pid, None)
                    if not ok:
                        self.verify_log[pub] = False
                    self.wire.pop(pid)
                    self._page_span.pop(pid, None)
            elif act["op"] == "cow":
                self.cache = self._copy_fn(self.cache, act["src"],
                                           act["dst"])

    def _fresh_solo(self) -> dict:
        """The solo cache, zeroed: each admission prefills from zeros, as
        the reference's (functional) solo cache does."""
        with torch.inference_mode():
            for leaf in self._solo.values():
                if isinstance(leaf, torch.Tensor):
                    leaf.zero_()
        return dict(self._solo, len=0)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------ admission path
    def _rid_held(self, rid) -> bool:
        """Is ``rid``'s verify state still live in EITHER family?  The
        verify log is one rid-keyed dict shared across families."""
        held = (
            rid in self.verify_log
            or any(q.rid == rid for q in self.sched.queue)
            or any(s.req is not None and s.req.rid == rid
                   for s in self.sched.slots)
        )
        if not self.paged:
            # batched-row wires are rid-keyed, so the store itself tracks
            # in-flight and retired-undrained rids
            held = held or rid in self.wire
        if self._crypto is not None:
            held = held or self._crypto._rid_held(rid)
        return held

    def submit(self, req) -> None:
        """Queue one request; dispatches on ``req.family`` ("llm" default
        / "crypto" when the crypto lane is armed)."""
        family = getattr(req, "family", "llm")
        if family == "crypto":
            if self._crypto is None:
                raise ValueError(
                    "engine built without crypto_slots=; pass "
                    "crypto_slots>=1 to accept crypto-family requests"
                )
            self.crypto_ctx.validate(req)
        elif family != "llm":
            raise ValueError(f"unknown request family {family!r}; "
                             f"expected 'llm' or 'crypto'")
        if self.rns_verify and self._rid_held(req.rid):
            # verify state is keyed on rid; refuse the collision
            # before any slot is bound or device work runs
            raise ValueError(
                f"rid {req.rid} already holds verify state (queued, in "
                f"flight, or retired-undrained); use unique rids, or "
                f"drain_completed() between reuses"
            )
        if family == "crypto":
            self.crypto.queue.append(req)
        else:
            self.sched.submit(req)

    def try_admit(self, now: float = 0.0) -> list[Slot]:
        """Admit as many queued requests as there are FREE slots; each
        admission chunk-prefills the prompt and splices it into the
        batched cache.  Returns the admitted slots (normally now in
        DECODE; already FREE again if the first token retired the
        request — one-token budget or instant EOS)."""
        admitted = []
        while True:
            slot = self.sched.admit_next(now)
            if slot is None:
                break
            self._prefill_into(slot, now)
            admitted.append(slot)
        if self._crypto is not None:
            self._crypto._crypto_admit(now)
        return admitted

    def _prefill_into(self, slot: Slot, now: float) -> None:
        if self.paged:
            return self._prefill_into_paged(slot, now)
        req = slot.req
        prompt = [int(t) for t in req.prompt]
        plen, C = len(prompt), self.prefill_chunk
        solo = self._fresh_solo()
        bucket = self._pick_bucket(plen)
        if bucket is not None:
            # one padded extend call; the pad beyond plen - 1 is causally
            # invisible (logit_index reads the last real position) and
            # decode writes overwrite it before it is ever attended
            toks = self._tokens([prompt + [0] * (bucket - plen)])
            logits, solo = self._extend_fn(self.params, solo, toks, 0,
                                           plen - 1)
            self.bucket_hits[bucket] += 1
            self.bucket_pad_tokens += bucket - plen
            self.bucket_real_tokens += plen
        else:
            n_chunks = -(-plen // C)
            if self.prefill_buckets is not None:
                self.bucket_fallbacks += 1
                self.bucket_pad_tokens += n_chunks * C - plen
                self.bucket_real_tokens += plen
            prompt = prompt + [0] * (n_chunks * C - plen)
            last = (plen - 1) - (n_chunks - 1) * C
            for ci in range(n_chunks):
                toks = self._tokens([prompt[ci * C:(ci + 1) * C]])
                # only the final chunk's last real prompt position is read
                idx = last if ci == n_chunks - 1 else 0
                logits, solo = self._extend_fn(self.params, solo, toks,
                                               ci * C, idx)
        first = int(torch.argmax(logits[0, 0]))
        self.cache = self._insert_fn(self.cache, solo, slot.index)
        if self.rns_verify:
            fp = self._fp_fn(self.cache, slot.index, plen)
            self.wire.put(req.rid, self.codec.encode_array(
                fp, channel_major=True))
        if self.sched.start_decode(slot, first, now) and self.rns_verify:
            # instant retirement (one-token budget / immediate EOS) never
            # reaches step()'s retirement branch — verify here instead
            self.verify_log[req.rid] = self.verify_request(req)

    def _prefill_into_paged(self, slot: Slot, now: float) -> None:
        """Paged admission prefill: chunks write straight into the pool
        through the slot's page-table row.  Positions below
        ``slot.prefill_start`` are not recomputed — the scheduler mapped
        registry pages holding that shared prefix at admission; each
        chunk's write barrier (``plan_write``) allocates or copies the
        pages the chunk lands on before its extend runs.

        With a bucket ladder, a prompt whose remaining extend fits a bucket
        prefills in ONE padded call through the padded write barrier: the
        real span goes through the page table, and every pad token to a
        one-call scratch page taken from the slot's reservation, so pad K/V
        never lands in a shared, registered or retained page."""
        req = slot.req
        prompt = [int(t) for t in req.prompt]
        plen, C = len(prompt), self.prefill_chunk
        start = slot.prefill_start
        need = plen - start   # tokens the extend computes
        bucket = self.sched.bucket_for(need)
        if bucket is not None:
            self._exec_actions(self.sched.plan_write(slot, start, need))
            scratch, acts = self.sched.alloc_scratch(slot)
            self._exec_actions(acts)
            toks = self._tokens([prompt[start:] + [0] * (bucket - need)])
            logits, self.cache = self._extend_fn(
                self.params, self.cache, toks, start, need - 1,
                self._table([self.sched.table[slot.index]]), need, scratch)
            self.sched.free_scratch(scratch)
            self.bucket_hits[bucket] += 1
            self.bucket_pad_tokens += bucket - need
            self.bucket_real_tokens += need
        else:
            n_chunks = -(-need // C)
            if self.prefill_buckets is not None:
                self.bucket_fallbacks += 1
                self.bucket_pad_tokens += n_chunks * C - need
                self.bucket_real_tokens += need
            padded = prompt + [0] * (start + n_chunks * C - plen)
            last = (plen - 1) - (start + (n_chunks - 1) * C)
            for ci in range(n_chunks):
                s0 = start + ci * C
                self._exec_actions(self.sched.plan_write(slot, s0, C))
                toks = self._tokens([padded[s0:s0 + C]])
                idx = last if ci == n_chunks - 1 else 0
                # chunk-grid pads write through the table (their pages are
                # reserved for this slot's decode span anyway): valid = the
                # full width, the parking page as a dead scratch operand
                logits, self.cache = self._extend_fn(
                    self.params, self.cache, toks, s0, idx,
                    self._table([self.sched.table[slot.index]]), C, 0)
        first = int(torch.argmax(logits[0, 0]))
        # publish the fully covered prompt pages for later admissions
        self.sched.register_prompt(slot, prompt)
        if self.rns_verify:
            self._fingerprint_prompt_pages(slot, plen)
        if self.sched.start_decode(slot, first, now):
            self._retire_paged(req)

    def _fingerprint_prompt_pages(self, slot: Slot, plen: int) -> None:
        """Encode one RRNS codeword per prompt page of ``slot`` that does
        not carry one yet — shared registry pages keep their publisher's
        codeword, so one wire entry covers every reader."""
        ps = self.page_size
        for lp, pid in self.sched.slot_pages(slot.index):
            off = lp * ps
            if off >= plen:
                break   # decode-region pages are mutable: never fingerprinted
            if pid in self.wire:
                continue
            self._page_span[pid] = min(ps, plen - off)
            self._page_pub[pid] = slot.req.rid
            self.wire.put(pid, self._page_codeword(pid))

    def _retire_paged(self, req: Request) -> None:
        """Paged retirement: verify the request's prompt-page fingerprints
        while its table row is still mapped, then release the row —
        ``'freed'`` pages drop their codewords (already verified),
        ``'retained'``/``'shared'`` pages keep them for later or current
        readers."""
        if self.rns_verify:
            self.verify_log[req.rid] = self.verify_request(req)
        for pid, disp in self.sched.release_pages(req.slot_index):
            if disp == "freed" and self.rns_verify:
                self.wire.pop(pid)
                self._page_span.pop(pid, None)
                self._page_pub.pop(pid, None)

    # --------------------------------------------------------- decode loop
    def step(self, now: float = 0.0) -> list:
        """One batched decode step over every DECODE slot, plus one
        ``crypto_chunk``-bit ladder advance of the crypto lane when it is
        armed; returns the requests (both families) that retired."""
        crypto_retired = (self._crypto._crypto_step(now)
                          if self._crypto is not None else [])
        decoding = self.sched.decoding_slots()
        if not decoding:
            return crypto_retired
        if self.paged:
            # write barrier for this step's one-token writes: a page
            # boundary allocates, divergence into a shared page copies —
            # all before the table's snapshot rides into the decode step
            for slot in decoding:
                self._exec_actions(
                    self.sched.plan_write(slot, slot.next_pos, 1))
        toks, poss = self.sched.step_rows()
        args = [self.params, self.cache, self._tokens(toks)[:, None], poss]
        if self.paged:
            args.append(self._table(self.sched.table))
        nxt, self.cache = self._decode_fn(*args)
        nxt = nxt.tolist()
        retired = []
        for slot in decoding:
            self.sched.advance(slot)
            req = slot.req
            if self.sched.record_token(slot, nxt[slot.index], now):
                retired.append(req)
                if self.paged:
                    self._retire_paged(req)
                elif self.rns_verify:
                    self.verify_log[req.rid] = self.verify_request(req)
        return retired + crypto_retired

    @property
    def busy(self) -> bool:
        """Work anywhere in the engine: LLM queue/slots or crypto lane."""
        return self.sched.busy or (
            self._crypto is not None and self._crypto.busy)

    def run_to_completion(self, max_steps: int = 1 << 20) -> list:
        """Drain queue and slots (all arrivals already submitted)."""
        steps = 0
        while self.busy:
            self.try_admit(float(steps))
            if self.sched.decoding_slots() or (
                self._crypto is not None and self.crypto.running_slots()
            ):
                self.step(float(steps))
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serve loop exceeded max_steps")
        if self._crypto is None:
            return self.sched.completed
        return list(self.sched.completed) + list(self.crypto.completed)

    def drain_completed(self) -> list:
        """Hand back the retired requests and release the engine-held
        state keyed on them (wire buffers, verify entries)."""
        done, self.sched.completed = self.sched.completed, []
        if self._crypto is not None:
            done = done + self.crypto.completed
            self.crypto.completed = []
        if self.rns_verify:
            for r in done:
                if getattr(r, "family", "llm") == "crypto":
                    self.wire.pop(("crypto", r.rid), None)
                elif not self.paged:
                    # paged wires are page-keyed and already released
                    # with their pages at retirement
                    self.wire.pop(r.rid, None)
                self.verify_log.pop(r.rid, None)
        return done

    def jit_cache_sizes(self) -> dict:
        """Argument signatures per engine function (``serve_step.Traced``)
        under the reference's keys (``copy`` on the paged pool in place of
        ``insert``): every value stays 1 for the engine's lifetime (with
        ``prefill_buckets``, ``extend`` stays at the number of distinct
        padded widths used)."""
        sizes = {"decode": self._decode_fn._cache_size(),
                 "extend": self._extend_fn._cache_size()}
        if self.paged:
            sizes["copy"] = self._copy_fn._cache_size()
        else:
            sizes["insert"] = self._insert_fn._cache_size()
        if self._fp_fn is not None:
            sizes["fingerprint"] = self._fp_fn._cache_size()
        if self._crypto is not None:
            sizes.update(self._crypto.jit_cache_sizes())
        return sizes

    def _pick_bucket(self, plen: int) -> int | None:
        """Smallest armed bucket >= plen, or None (buckets off / prompt
        longer than every bucket -> chunk-loop fallback)."""
        if self.prefill_buckets is None:
            return None
        for b in self.prefill_buckets:
            if b >= plen:
                return b
        return None

    def bucket_stats(self) -> dict:
        """Bucketed-prefill accounting: hits per width, chunk-loop
        fallbacks, and pad overhead (pad tokens / real tokens) over all
        prefill traffic.  On the paged pool "real" means the tokens the
        extend computed: a shared prefix mapped from the registry is
        neither padded nor recomputed."""
        if self.prefill_buckets is None:
            raise RuntimeError("engine built without prefill_buckets=")
        real = self.bucket_real_tokens
        return {
            "widths": list(self.prefill_buckets),
            "hits": {str(b): n for b, n in self.bucket_hits.items()},
            "fallbacks": self.bucket_fallbacks,
            "pad_tokens": self.bucket_pad_tokens,
            "real_tokens": real,
            "pad_overhead": (self.bucket_pad_tokens / real) if real else 0.0,
        }

    def page_stats(self) -> dict:
        """Pool, dedup and copy-on-write counters (paged only), plus the
        wire's verify/repair counters under ``rns_verify`` — the ``paging``
        block of the serve CLI's report."""
        if not self.paged:
            raise RuntimeError("engine built without page_size=")
        stats = self.sched.page_stats()
        if self.rns_verify:
            stats["fingerprints"] = dict(self.wire.stats)
        return stats

    # ------------------------------------------------- RNS integrity path
    def _require_verify(self):
        if not self.rns_verify:
            raise RuntimeError("engine built without rns_verify=True")

    def verify_request(self, req) -> bool:
        """Recompute ``req``'s prompt-region fingerprints and compare their
        RNS encodings bitwise against the stored wire buffers: one codeword
        over the slot row's [0, plen), keyed by rid, or on the paged pool
        one per mapped prompt PAGE of the slot's table row (a shared page
        checks against its publisher's codeword).  Valid until the row or
        pages are reused by a later admission; the engine calls this
        automatically at retirement.  Crypto-family requests verify their
        lane slot's immutable rows (``CryptoEngine.verify_request``)."""
        self._require_verify()
        if getattr(req, "family", "llm") == "crypto":
            return self._crypto.verify_request(req)
        if self.paged:
            ok = True
            for lp, pid in self.sched.slot_pages(req.slot_index):
                if lp * self.page_size >= len(req.prompt):
                    break   # decode-region pages carry no fingerprints
                if pid in self.wire:
                    ok &= self.wire.matches(pid, self._page_codeword(pid))
            return ok
        fp = self._fp_fn(self.cache, req.slot_index, len(req.prompt))
        fresh = self.codec.encode_array(fp, channel_major=True)
        return self.wire.matches(req.rid, fresh)

    def wire_ok(self, key) -> bool:
        """Codeword self-consistency of one stored wire buffer (RRNS
        redundant-channel check), without touching the cache.  ``key`` is a
        rid on the batched cache, a physical page id on the paged pool."""
        self._require_verify()
        return self.wire.ok(key)

    def repair_wire(self, key) -> dict:
        """Locate-and-correct one stored wire buffer in place via
        ``dist.fault.repair_packed``; returns its report dict.  On the
        paged pool a shared page's buffer is repaired once, and every
        reader re-verifies against the fixed codeword."""
        self._require_verify()
        return self.wire.repair(key)

    def corrupt_wire(self, key, channel: int = 0, delta: int = 1,
                     index: int = 0) -> None:
        """Fault injection for tests and drivers: modular-bump one residue
        of a stored wire buffer (still a valid residue, so only the
        redundant channels catch it)."""
        self._require_verify()
        self.wire.corrupt(key, channel=channel, delta=delta, index=index)
