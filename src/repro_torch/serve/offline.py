"""Saturation-grade offline inference harness (the reference's DESIGN.md
§16), ported from ``repro/serve/offline.py``.

``launch/serve.py --mode sim`` replays traces on a single-threaded tick
clock: it measures the ENGINE, never the system.  This module is the
MLPerf-offline-style measurement layer on top of it:

  * ``OfflineInference`` — wall-clock driver over one or more
    ``ContinuousBatcher`` replicas.  ``warmup()`` reaches every argument
    signature of every (bucket, family) path BEFORE timing starts (and pays
    the card's first-use costs there); ``run()`` then replays a workload
    under the real clock and checks that steady state added none.
  * ``CompletionPump`` — ONE background detokenize/callback thread fed by a
    bounded queue, so host-side completion work overlaps the decode steps.
    First-error-wins: a failed callback surfaces on the next ``put()`` /
    ``flush()`` / ``close()``, never silently.  The callback only ever sees
    host data (a retired request's ``out`` is a list of ints).
  * ``ReplicaSet`` — data-parallel engine replicas behind ONE shared
    admission deque; a request goes to the least-loaded replica with free
    capacity for its family.  ``replica_devices`` gives each replica a card
    when the cards divide evenly (else every replica shares the first).

The closed-loop QPS search that drives this harness to saturation lives in
``serve/loadgen.py``.
"""
from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np
import torch

from ..dist import _tree

__all__ = [
    "CompletionPump",
    "OfflineInference",
    "ReplicaSet",
    "default_callback",
    "pow2_buckets",
    "replica_devices",
    "sample_stats",
]


def sample_stats(xs) -> dict:
    """n/mean/p50/p95/p99 summary of a sample list.

    An empty sample returns the explicit ``n: 0`` record (all stats 0.0)
    instead of crashing ``np.percentile`` on ``[]`` — a family filter
    that leaves zero completed requests must not kill report generation.
    """
    if not xs:
        return {"n": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {
        "n": int(a.size),
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
    }


def pow2_buckets(cache_len: int, lo: int = 8) -> tuple[int, ...]:
    """Power-of-two prefill buckets ``lo, 2*lo, ... , cache_len`` (the
    default bucket ladder of ``--mode offline``).  ``cache_len`` itself
    is appended when it is not a power of two so every admissible prompt
    hits a bucket (widths > 512 are multiples of 512 whenever cache_len
    is, per the engine's flash-chunk rule)."""
    if cache_len < 1:
        raise ValueError("cache_len must be >= 1")
    lo = max(1, min(lo, cache_len))
    out = []
    b = 1 << (lo - 1).bit_length()
    while b < cache_len:
        out.append(b)
        b <<= 1
    out.append(cache_len)
    return tuple(out)


def default_callback(req) -> str:
    """Minimal "detokenize": completed crypto requests render their
    big-int result, LLM requests their output token ids.  Real servers
    swap in a tokenizer's ``decode`` — anything swapped in runs on the
    pump thread, overlapped with device decode."""
    if getattr(req, "family", "llm") == "crypto":
        return f"{req.op}:{req.result}"
    return " ".join(str(t) for t in req.out)


class CompletionPump:
    """Background completion/detokenize thread behind a bounded queue.

    ``put(req)`` enqueues a retired request for the worker to run
    ``callback(req)`` on; the driver thread returns to stepping the
    engine immediately unless the queue is full (bounded = backpressure:
    a slow callback eventually throttles the producer instead of growing
    an unbounded buffer).  Results land in ``completed`` in submission
    order (single worker = FIFO).

    Error contract (the ``train/checkpointer.py`` pattern): the FIRST
    callback exception is held and re-raised from the next ``put()`` /
    ``flush()`` / ``close()`` — never dropped, no silent hang.  After an
    error the worker keeps draining the queue (dropping items) so a
    producer blocked on a full queue always unblocks.
    """

    _SENTINEL = object()

    def __init__(self, callback, *, queue_size: int = 64):
        if queue_size < 1:
            raise ValueError("queue_size must be >= 1")
        self._callback = callback
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self.completed: list = []  # (request, callback result), FIFO
        self._error: BaseException | None = None
        self._error_lock = threading.Lock()
        self._closed = False
        self.processed = 0
        self.dropped = 0  # items drained after the first error
        self.max_depth = 0
        self.blocked_puts = 0  # puts that found the queue full
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name="completion-pump"
        )
        self._thread.start()

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # don't mask an in-flight exception with the held one: it already
        # surfaced (or will, from the caller's own flush/close)
        self.close(raise_error=exc[0] is None)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                self._q.task_done()
                return
            try:
                if self._error is not None:
                    self.dropped += 1  # drain-after-error: never deadlock
                    continue
                self.completed.append((item, self._callback(item)))
                self.processed += 1
            except BaseException as e:
                with self._error_lock:
                    if self._error is None:  # first failure wins
                        self._error = e
            finally:
                self._q.task_done()

    def _check_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- producing ---------------------------------------------------------

    def put(self, req) -> None:
        """Enqueue one retired request; blocks when the queue is full
        (backpressure); re-raises the first worker error if any."""
        self._check_error()
        if self._closed:
            raise RuntimeError("CompletionPump is closed")
        if self._q.full():
            self.blocked_puts += 1
        self._q.put(req)  # blocks when full
        self.max_depth = max(self.max_depth, self._q.qsize())

    def flush(self) -> None:
        """Block until every enqueued completion has run; re-raise the
        first worker error if any callback failed."""
        self._q.join()
        self._check_error()

    def close(self, *, raise_error: bool = True) -> None:
        """Idempotent: stop the worker and join it.  With ``raise_error``
        (default) the held error surfaces here; pass False on exception
        paths where another error is already propagating."""
        if not self._closed:
            self._closed = True
            self._q.put(self._SENTINEL)
            self._thread.join()
        if raise_error:
            self._check_error()

    def stats(self) -> dict:
        return {
            "queue_size": self._q.maxsize,
            "processed": self.processed,
            "dropped": self.dropped,
            "max_depth": self.max_depth,
            "blocked_puts": self.blocked_puts,
        }


def replica_devices(n: int, devices=None) -> list:
    """One ``torch.device`` per replica.

    ``devices`` defaults to every CUDA card, and with no card and no
    ``devices`` it raises: the CPU is used only when the caller names it.
    When the devices divide evenly among ``n`` replicas (at least one
    each), replica i runs on device i; otherwise every replica runs on the
    first device — the single-card case, where replicas still exercise the
    shared-admission protocol and the report counts one chip.  Each
    replica holds one device: a replica spanning several cards would be
    several SPMD ranks, with the shared admission queue crossing processes.

    >>> replica_devices(3, [torch.device("cpu")])
    [device(type='cpu'), device(type='cpu'), device(type='cpu')]
    >>> replica_devices(2, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])
    [device(type='cuda', index=0), device(type='cuda', index=1)]
    """
    if n < 1:
        raise ValueError("need >= 1 replica")
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("replica_devices: no CUDA card; pass "
                               "devices=[torch.device('cpu')] to run the "
                               "replicas on the CPU")
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("need >= 1 device")
    if len(devs) >= n and len(devs) % n == 0:
        return devs[:n]
    return [devs[0]] * n


class ReplicaSet:
    """Data-parallel engine replicas behind ONE shared admission deque.

    ``submit`` parks requests in arrival order; ``pump(now)`` dispatches
    each to the least-loaded replica that has free capacity for its
    family (LLM: FREE slots beyond the engine's own backlog; crypto
    modexp: FREE lane slots beyond queued ladders; crypto one-shots:
    round-robin — they execute inside admission and never bind a slot).
    A request whose family has no capacity anywhere stays parked; FIFO
    is preserved WITHIN each family (capacity is family-wide, so a
    later same-family request can never jump an earlier one).
    """

    def __init__(self, engines: list):
        if not engines:
            raise ValueError("need >= 1 engine replica")
        self.engines = list(engines)
        self.queue: list = []  # shared admission queue (arrival order)
        self.steps = 0  # total engine decode/ladder steps across replicas
        self.dispatched = [0] * len(engines)
        self._rr = 0  # one-shot round-robin cursor
        # fingerprint verdicts harvested at retirement (the engines pop
        # their verify logs when drained, so the set keeps the tally)
        self.verify_ok = 0
        self.verify_failed = 0

    # -- capacity probes ---------------------------------------------------

    @staticmethod
    def _free_llm(eng) -> int:
        free = sum(1 for s in eng.sched.slots if s.state == "FREE")
        return free - len(eng.sched.queue)

    @staticmethod
    def _free_modexp(eng) -> int:
        if eng.crypto is None:
            return 0
        free = sum(1 for s in eng.crypto.slots if s.state == "FREE")
        queued = sum(1 for r in eng.crypto.queue if r.op == "modexp")
        return free - queued

    # -- shared-queue protocol ---------------------------------------------

    def submit(self, req) -> None:
        self.queue.append(req)

    def pump(self, now: float) -> int:
        """One dispatch pass over the shared queue; returns how many
        requests were handed to a replica.  ``now`` is threaded through
        for symmetry with the engine API (dispatch itself stamps
        nothing — admission stamps ``t_admit``)."""
        del now
        placed, rest = 0, []
        for req in self.queue:
            family = getattr(req, "family", "llm")
            ei = self._pick(family, req)
            if ei is None:
                rest.append(req)
                continue
            self.engines[ei].submit(req)
            self.dispatched[ei] += 1
            placed += 1
        self.queue = rest
        return placed

    def _pick(self, family: str, req) -> int | None:
        if family == "crypto":
            armed = [i for i, e in enumerate(self.engines)
                     if e.crypto is not None]
            if not armed:
                raise ValueError(
                    "crypto-family request but no replica has a crypto "
                    "lane; build engines with crypto_slots >= 1"
                )
            if req.op != "modexp":
                # one-shots execute inside admission: spread round-robin
                self._rr += 1
                return armed[self._rr % len(armed)]
            best = max(armed, key=lambda i: self._free_modexp(
                self.engines[i]))
            return best if self._free_modexp(self.engines[best]) > 0 \
                else None
        best = max(range(len(self.engines)),
                   key=lambda i: self._free_llm(self.engines[i]))
        return best if self._free_llm(self.engines[best]) > 0 else None

    # -- stepping ----------------------------------------------------------

    @property
    def stepping(self) -> bool:
        """Any replica has device work this instant (decoding rows or
        running ladders) — False means the set is idle waiting on
        arrivals or free capacity."""
        return any(
            e.sched.decoding_slots()
            or (e.crypto is not None and e.crypto.running_slots())
            for e in self.engines
        )

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(e.busy for e in self.engines)

    def step_all(self, now: float) -> list:
        """Admit + one decode/ladder step on every replica with work;
        returns the requests (all families, all replicas) that retired."""
        retired = []
        for eng in self.engines:
            eng.try_admit(now)
            if eng.sched.decoding_slots() or (
                eng.crypto is not None and eng.crypto.running_slots()
            ):
                eng.step(now)
                self.steps += 1
            if eng.rns_verify:
                # harvest before drain_completed pops the log entries
                for ok in eng.verify_log.values():
                    self.verify_ok += bool(ok)
                    self.verify_failed += not ok
            retired.extend(eng.drain_completed())
        return retired


class OfflineInference:
    """Wall-clock saturation harness over data-parallel engine replicas.

    Lifecycle: construct -> ``warmup()`` (reaches every (bucket, family)
    signature and snapshots the census ``jit_cache_sizes()``) ->
    ``run(reqs)`` one or more times (timed; checks zero new signatures in
    steady state via ``require_steady_state``).  Engine kwargs mirror
    ``ContinuousBatcher``; ``buckets`` arms length-bucketed single-call
    prefill, ``overlap`` routes completions through a ``CompletionPump``
    instead of running the callback inline on the driver thread.
    ``page_size`` puts every replica on the paged, prefix-sharing pool —
    buckets compose with it through the padded write barrier, and warmup
    also reaches the copy-on-write copy so steady state stays
    retrace-free.  The replicas go on ``replica_devices`` of every card
    (every one on the CPU when ``params`` live there); each gets its own
    copy of ``params`` on its device.
    """

    def __init__(self, cfg, params, *, n_slots: int, cache_len: int,
                 prefill_chunk: int = 32,
                 buckets: tuple | None = None,
                 replicas: int = 1,
                 overlap: bool = True,
                 queue_size: int = 64,
                 callback=None,
                 rns_verify: bool = False,
                 page_size: int | None = None, n_pages: int | None = None,
                 prefix_share: bool = True,
                 crypto_slots: int = 0, crypto_ctx=None,
                 crypto_chunk: int = 8):
        from .batcher import ContinuousBatcher

        home = params["embed"].device
        self.devices = replica_devices(
            replicas, [home] if home.type == "cpu" else None)
        self.engines = [
            ContinuousBatcher(
                cfg, (params if dev == home else
                      _tree.tree_map(lambda t: t.to(dev), params)),
                n_slots=n_slots, cache_len=cache_len,
                prefill_chunk=prefill_chunk, prefill_buckets=buckets,
                rns_verify=rns_verify,
                page_size=page_size, n_pages=n_pages,
                prefix_share=prefix_share,
                crypto_slots=crypto_slots, crypto_ctx=crypto_ctx,
                crypto_chunk=crypto_chunk,
            )
            for dev in self.devices
        ]
        self.replica_set = ReplicaSet(self.engines)
        self.cache_len = int(cache_len)
        self.buckets = self.engines[0].prefill_buckets
        self.overlap = bool(overlap)
        self.queue_size = int(queue_size)
        self.callback = callback if callback is not None else \
            default_callback
        self.n_chips = len(set(self.devices))
        self._warm_sizes: list[dict] | None = None
        self.completions: list = []  # (request, callback result) last run
        self.on_step = None  # default per-loop hook

    # -- warmup ------------------------------------------------------------

    def _warm_llm_plens(self) -> list[int]:
        """One prompt length per compiled prefill width: each armed
        bucket gets the longest admissible prompt that selects it (a
        bucket no admissible prompt can select is skipped — it can never
        compile under traffic either); without buckets, one multi-chunk
        prompt compiles the chunk-loop graph."""
        top = self.cache_len - 2  # warmup decodes 2: plen+2 <= cache_len
        if self.buckets is None:
            C = self.engines[0].prefill_chunk
            return [min(2 * C, top)]
        plens, prev = [], 0
        for b in self.buckets:
            hi = min(b, top)
            if hi > prev:  # a prompt of length hi selects bucket b
                plens.append(hi)
            prev = b
        return plens

    def warmup(self) -> dict:
        """Reach every (bucket, family) signature on every replica BEFORE
        timing starts — each bucket width, the copy-on-write copy, the
        fingerprint and the crypto lane's functions, with the card's first
        uses of its libraries and allocator — then snapshot the census
        that ``require_steady_state`` holds ``run()`` to.  Warmup requests
        use negative rids (real traffic uses non-negative) and are
        drained, not reported."""
        from .scheduler import Request

        for ei, eng in enumerate(self.engines):
            rid = -(1 + 1000 * ei)  # unique negative ids per replica
            for wi, plen in enumerate(self._warm_llm_plens()):
                # max_new=2 reaches the decode step (1 would retire at
                # start_decode, before any batched step runs).  One
                # DISTINCT token per warmup prompt: on the paged pool an
                # earlier warmup registers its prompt pages, and a
                # repeated token would prefix-hit — shrinking the next
                # prompt's real extend and silently skipping the bucket
                # width it was meant to compile.
                tok = 3 + wi % (eng.cfg.vocab - 3)
                eng.submit(Request(rid=rid, prompt=[tok] * plen, max_new=2,
                                   eos=-1))
                rid -= 1
            if (eng.paged and eng.sched.registry is not None
                    and eng.prefill_chunk < eng.page_size
                    and eng.page_size + 2 <= self.cache_len):
                # reach the copy-on-write copy: a full-prefix re-admission
                # of a one-page prompt re-writes the shared tail inside the
                # registered page (chunk-grained restart below the page
                # boundary), which is exactly the CoW the first timed
                # prefix hit would otherwise meet
                dup = [2] * eng.page_size
                for _ in range(2):
                    eng.submit(Request(rid=rid, prompt=dup, max_new=2,
                                       eos=-1))
                    rid -= 1
            if eng.crypto is not None:
                from .crypto import CryptoRequest

                ctx = eng.crypto_ctx
                MMp = ctx.baseB.M * ctx.baseBp.M
                n = 5
                while n < ctx.n_max and math.gcd(n, MMp) != 1:
                    n += 2
                eng.submit(CryptoRequest(rid=rid, op="modexp", a=3, b=5,
                                         n=n))
                eng.submit(CryptoRequest(rid=rid - 1, op="modmul", a=2,
                                         b=3, n=n))
                eng.submit(CryptoRequest(rid=rid - 2, op="divmod", a=7,
                                         b=3))
            eng.run_to_completion()
            eng.drain_completed()
            # warmup hits count signature coverage, not traffic: reset
            if eng.prefill_buckets is not None:
                eng.bucket_hits = {b: 0 for b in eng.prefill_buckets}
                eng.bucket_fallbacks = 0
                eng.bucket_pad_tokens = eng.bucket_real_tokens = 0
        self._warm_sizes = [e.jit_cache_sizes() for e in self.engines]
        return {
            "replicas": len(self.engines),
            "warmed_plens": self._warm_llm_plens(),
            "jit_traces": [dict(s) for s in self._warm_sizes],
        }

    # -- steady-state assertion --------------------------------------------

    def require_steady_state(self) -> None:
        """Raise unless the census is EXACTLY the warmup snapshot — a timed
        run that met a new argument signature was mis-warmed, and its
        numbers include first-use costs."""
        if self._warm_sizes is None:
            raise RuntimeError("warmup() has not run")
        live = [e.jit_cache_sizes() for e in self.engines]
        if live != self._warm_sizes:
            raise RuntimeError(
                f"steady state retraced: warmup compiled "
                f"{self._warm_sizes}, after run: {live}"
            )

    def steady_state_ok(self) -> bool:
        try:
            self.require_steady_state()
        except RuntimeError:
            return False
        return True

    # -- timed run ---------------------------------------------------------

    def run(self, reqs: list, *, clock=time.perf_counter,
            on_step=None) -> dict:
        """Replay ``reqs`` under the real clock and report saturation
        metrics.  Arrivals are offsets in seconds from the run's t0
        (offline mode zeroes them: everything available at once);
        ``t_admit/t_first/t_done`` land in the same timebase, so TTFT
        and latency come straight off the request stamps.  ``on_step``
        fires once per driver loop."""
        if self._warm_sizes is None:
            raise RuntimeError(
                "warmup() must complete before timed traffic — otherwise "
                "the run pays first-use costs mid-measurement"
            )
        rs = self.replica_set
        if on_step is None:
            on_step = self.on_step
        reqs = sorted(reqs, key=lambda r: getattr(r, "arrival", 0.0))
        pump = (CompletionPump(self.callback, queue_size=self.queue_size)
                if self.overlap else None)
        inline: list = []
        i, n = 0, len(reqs)
        steps0 = rs.steps
        t0 = clock()
        try:
            while i < n or rs.busy:
                now = clock() - t0
                while i < n and reqs[i].arrival <= now:
                    rs.submit(reqs[i])
                    i += 1
                rs.pump(now)
                if on_step is not None:
                    on_step()
                retired = rs.step_all(clock() - t0)
                for r in retired:
                    if pump is not None:
                        pump.put(r)
                    else:
                        inline.append((r, self.callback(r)))
                if not retired and not rs.stepping and i < n:
                    # idle until the next open-loop arrival (short naps:
                    # an admission may free up before the next arrival)
                    gap = reqs[i].arrival - (clock() - t0)
                    if gap > 0:
                        time.sleep(min(gap, 5e-4))
            if pump is not None:
                pump.flush()  # completion work counts inside the wall
            wall = clock() - t0
        finally:
            if pump is not None:
                pump.close(raise_error=False)
        self.completions = list(pump.completed) if pump is not None \
            else inline
        return self._report(wall, steps0, pump)

    def _report(self, wall: float, steps0: int, pump) -> dict:
        done = [r for r, _ in self.completions]
        llm = [r for r in done if getattr(r, "family", "llm") == "llm"]
        crypto = [r for r in done if getattr(r, "family", "llm")
                  == "crypto"]
        toks = sum(len(r.out) for r in llm)
        report = {
            "requests": len(done),
            "llm_requests": len(llm),
            "crypto_requests": len(crypto),
            "tokens_out": toks,
            "wall_s": wall,
            "arrival_span_s": max(
                (getattr(r, "arrival", 0.0) for r in done), default=0.0
            ),
            "tok_per_s": toks / wall if wall > 0 else 0.0,
            "tok_per_s_per_chip": (toks / wall / self.n_chips)
            if wall > 0 else 0.0,
            "n_chips": self.n_chips,
            "replicas": len(self.engines),
            "engine_steps": self.replica_set.steps - steps0,
            "dispatched": list(self.replica_set.dispatched),
            "ttft_s": sample_stats(
                [r.t_first - r.arrival for r in llm
                 if r.t_first is not None]
            ),
            "latency_s": sample_stats(
                [r.t_done - r.arrival for r in done
                 if r.t_done is not None]
            ),
            "overlap": {
                "enabled": self.overlap,
                **(pump.stats() if pump is not None else {}),
            },
            "retrace_free": self.steady_state_ok(),
            "jit_traces": [dict(e.jit_cache_sizes())
                           for e in self.engines],
        }
        if self.buckets is not None:
            agg = {
                "widths": list(self.buckets),
                "hits": {str(b): 0 for b in self.buckets},
                "fallbacks": 0, "pad_tokens": 0, "real_tokens": 0,
            }
            for e in self.engines:
                st = e.bucket_stats()
                for k, v in st["hits"].items():
                    agg["hits"][k] += v
                for k in ("fallbacks", "pad_tokens", "real_tokens"):
                    agg[k] += st[k]
            agg["pad_overhead"] = (
                agg["pad_tokens"] / agg["real_tokens"]
                if agg["real_tokens"] else 0.0
            )
            report["buckets"] = agg
        if self.engines[0].paged:
            report["paging"] = [e.page_stats() for e in self.engines]
        return report
