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
  * ``RankReplicaSet`` — the same set when a replica spans several ranks
    (one process a card): ``replica_meshes`` carves the W ranks of the
    process group into ``n`` one-axis ``("data",)`` meshes, each rank
    builds only its own replica's engine on its mesh, and the deque and the
    dispatch live on rank 0, the controller.  Each driver tick is one
    gather of the replicas' capacities and retirements to rank 0 and one
    broadcast of its placements back, over a gloo group; the report exists
    on rank 0.

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
import torch.distributed as dist

from ..dist import _tree

__all__ = [
    "CompletionPump",
    "OfflineInference",
    "RankReplicaSet",
    "ReplicaSet",
    "default_callback",
    "pow2_buckets",
    "replica_devices",
    "replica_meshes",
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
    replica holds one device here; a replica spanning several cards is
    several SPMD ranks (``replica_meshes``, ``RankReplicaSet``).

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


def _world() -> int:
    """Ranks of the running process group; 1 when none runs."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def replica_meshes(n: int, device_type: str = "cuda") -> list:
    """Carve the ranks of the process group into ``n`` per-replica one-axis
    ``("data",)`` meshes: the reference's ``replica_meshes`` over ranks,
    one process a device, where the reference carves one process's
    devices.

    With no process group, or a one-rank group, the reference's one-device
    cases: ``[None]`` for one replica and ``[None] * n`` for several
    (every replica on the default device; ``replica_devices`` spreads one
    process's replicas over its cards).  Over W > 1 ranks replica i holds
    ranks ``[i*W/n, (i+1)*W/n)``.  W not divisible by n raises: the
    reference then puts every replica on the default device, which several
    processes cannot share.  Every rank must call it, with the same
    arguments: each replica's group is made collectively, in replica
    order.  Entry i is replica i's ``DeviceMesh`` on the ranks it holds and
    None on the others (a rank cannot address a mesh it is not in).  The
    groups are NCCL for "cuda" and gloo otherwise.

    >>> replica_meshes(3)                   # no process group
    [None, None, None]
    """
    if n < 1:
        raise ValueError("need >= 1 replica")
    W = _world()
    if W == 1:
        return [None] * n
    if W % n:
        raise ValueError(f"{W} ranks do not divide into {n} replicas: "
                         f"give each replica W/n ranks")
    from torch.distributed.device_mesh import DeviceMesh

    backend = "nccl" if device_type == "cuda" else "gloo"
    per, me = W // n, dist.get_rank()
    meshes = []
    for i in range(n):
        ranks = list(range(i * per, (i + 1) * per))
        group = dist.new_group(ranks, backend=backend)
        meshes.append(DeviceMesh.from_group(
            group, device_type, mesh=ranks, mesh_dim_names=("data",))
            if me in ranks else None)
    return meshes


def _stepping(eng) -> bool:
    """Has the replica device work this instant (decoding rows or running
    ladders)?"""
    return bool(eng.sched.decoding_slots()
                or (eng.crypto is not None and eng.crypto.running_slots()))


def _step_one(eng, now: float) -> tuple:
    """Admit + one decode/ladder step on one replica with work: (the
    requests that retired, steps taken (0 or 1), the fingerprint verdicts
    of its verify log, harvested before ``drain_completed`` pops them)."""
    eng.try_admit(now)
    stepped = 0
    if _stepping(eng):
        eng.step(now)
        stepped = 1
    verdicts = [bool(ok) for ok in eng.verify_log.values()] \
        if eng.rns_verify else []
    return eng.drain_completed(), stepped, verdicts


class _Dispatch:
    """The shared admission deque and the dispatch rule of a replica set,
    over one capacity record a replica (``capacity``), and the loop
    protocol both sets give ``OfflineInference.run``.

    ``engines`` are the replicas this process drives, ``mine`` their
    indices among the ``n``.  A driver tick is ``exchange(state,
    decide)``: the controller calls ``decide`` on every process's
    ``state`` (what ``step_local`` returned, or ``first_state`` before the
    first step) and every process gets its answer; ``absorb`` reads the
    retired requests out of those states, ``capacities`` the records to
    dispatch on, and ``deliver`` hands this process's placements to its
    engines.  ``collect`` gathers one list a process, in process order,
    and ``leaders`` indexes it by replica.
    """

    def __init__(self, engines: list, mine: list, n: int):
        if not engines:
            raise ValueError("need >= 1 engine replica")
        self.engines, self.mine = list(engines), list(mine)
        self.queue: list = []  # shared admission queue (arrival order)
        self.steps = 0  # total engine decode/ladder steps across replicas
        self.dispatched = [0] * n
        self._rr = 0  # one-shot round-robin cursor
        # fingerprint verdicts harvested at retirement (the engines pop
        # their verify logs when drained, so the set keeps the tally)
        self.verify_ok = 0
        self.verify_failed = 0
        self.exchange_ms: list = []  # host ms a tick crossing processes

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

    @classmethod
    def capacity(cls, eng) -> tuple:
        """What dispatch reads of one replica: (free LLM slots, free
        modexp slots, crypto lane armed)."""
        return (cls._free_llm(eng), cls._free_modexp(eng),
                eng.crypto is not None)

    # -- shared-queue protocol ---------------------------------------------

    def submit(self, req) -> None:
        self.queue.append(req)

    def place(self, caps: list) -> list:
        """One dispatch pass over the shared queue against ``caps``, one
        ``capacity`` record a replica: each request goes to the replica
        ``_choose`` names, whose record then counts it as that engine's
        backlog would, or stays parked.  Returns the ``(request,
        replica)`` placements in queue order."""
        caps = [list(c) for c in caps]
        placed, rest = [], []
        for req in self.queue:
            family = getattr(req, "family", "llm")
            ei = self._choose(family, req, caps)
            if ei is None:
                rest.append(req)
                continue
            placed.append((req, ei))
            self.dispatched[ei] += 1
            if family != "crypto":
                caps[ei][0] -= 1
            elif req.op == "modexp":
                caps[ei][1] -= 1
        self.queue = rest
        return placed

    def _choose(self, family: str, req, caps: list) -> int | None:
        if family == "crypto":
            armed = [i for i, c in enumerate(caps) if c[2]]
            if not armed:
                raise ValueError(
                    "crypto-family request but no replica has a crypto "
                    "lane; build engines with crypto_slots >= 1"
                )
            if req.op != "modexp":
                # one-shots execute inside admission: spread round-robin
                self._rr += 1
                return armed[self._rr % len(armed)]
            best = max(armed, key=lambda i: caps[i][1])
            return best if caps[best][1] > 0 else None
        best = max(range(len(caps)), key=lambda i: caps[i][0])
        return best if caps[best][0] > 0 else None

    def deliver(self, placed: list) -> None:
        """Submit the placements of this process's replicas to them."""
        for req, ei in placed:
            if ei in self.mine:
                self.engines[self.mine.index(ei)].submit(req)

    def _tally(self, verdicts) -> None:
        for ok in verdicts:
            self.verify_ok += bool(ok)
            self.verify_failed += not ok


class ReplicaSet(_Dispatch):
    """Data-parallel engine replicas behind ONE shared admission deque.

    ``submit`` parks requests in arrival order; ``pump(now)`` dispatches
    each to the least-loaded replica that has free capacity for its
    family (LLM: FREE slots beyond the engine's own backlog; crypto
    modexp: FREE lane slots beyond queued ladders; crypto one-shots:
    round-robin — they execute inside admission and never bind a slot).
    A request whose family has no capacity anywhere stays parked; FIFO
    is preserved WITHIN each family (capacity is family-wide, so a
    later same-family request can never jump an earlier one).

    In one process the loop protocol is local: a tick's state is the
    requests that retired, and ``exchange`` is ``decide`` itself.
    """

    controller = True

    def __init__(self, engines: list):
        super().__init__(engines, range(len(engines)), len(engines))
        self.leaders = list(self.mine)

    def pump(self, now: float) -> int:
        """One dispatch pass over the shared queue; returns how many
        requests were handed to a replica.  ``now`` is threaded through
        for symmetry with the engine API (dispatch itself stamps
        nothing — admission stamps ``t_admit``)."""
        del now
        placed = self.place(self.capacities())
        self.deliver(placed)
        return len(placed)

    def _pick(self, family: str, req) -> int | None:
        """``_choose`` on the engines' capacities as they stand."""
        return self._choose(family, req, self.capacities())

    def capacities(self) -> list:
        return [self.capacity(e) for e in self.engines]

    # -- stepping ----------------------------------------------------------

    @property
    def stepping(self) -> bool:
        """Any replica has device work this instant (decoding rows or
        running ladders) — False means the set is idle waiting on
        arrivals or free capacity."""
        return any(_stepping(e) for e in self.engines)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(e.busy for e in self.engines)

    def step_all(self, now: float) -> list:
        """Admit + one decode/ladder step on every replica with work;
        returns the requests (all families, all replicas) that retired."""
        retired = []
        for eng in self.engines:
            done, stepped, verdicts = _step_one(eng, now)
            self.steps += stepped
            self._tally(verdicts)
            retired.extend(done)
        return retired

    # -- the loop protocol, in one process ---------------------------------

    def first_state(self) -> list:
        return []

    step_local = step_all

    def exchange(self, state, decide):
        return decide(state)

    def absorb(self, state: list) -> list:
        return state

    def collect(self, objs: list) -> list:
        return list(objs)

    def from_root(self, obj):
        return obj


# the fields an engine fills in a request, sent back to the controller
_FILLED = ("out", "result", "slot_index", "t_admit", "t_first", "t_done")


class RankReplicaSet(_Dispatch):
    """A replica set across ranks: this rank's engine, replica ``replica``
    of ``n`` (ranks ``[replica*W/n, (replica+1)*W/n)``, which run it SPMD on
    the same requests in lock step, as ``ContinuousBatcher(mesh=)``
    requires), and on rank 0, the controller, the shared queue and the
    dispatch (``place``, the one-process rule).

    ``exchange`` is one driver tick's control traffic over ``group`` (a
    gloo group of every rank; None is the default group): a gather of
    every rank's ``local_state`` to rank 0 and a broadcast of rank 0's
    decision.  Rank 0 reads the state of each replica's first rank, its
    leader (``absorb``): its capacity record and the flags behind
    ``stepping`` and ``busy`` for this tick's dispatch, and the requests it
    retired in the last step (rid and the engine-filled fields) and its
    fingerprint verdicts into the tallies and the requests rank 0
    submitted.  ``dispatched``, ``steps`` and the verdict tallies count
    every replica on rank 0.
    """

    def __init__(self, engine, replica: int, n: int, *, group=None):
        super().__init__([engine], [int(replica)], int(n))
        self.n, self.replica, self.group = int(n), int(replica), group
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        per = self.world // self.n
        self.leaders = [i * per for i in range(self.n)]
        self.controller = self.rank == 0
        self._lead: list = []    # the leaders' last states (rank 0)
        self._inflight: dict = {}  # (family, rid) -> placed request

    def local_state(self, retired: list, stepped: int,
                    verdicts: list) -> dict:
        """What this rank sends each tick: its replica's capacity record
        and flags after the last step, and, from a leader, that step's
        retirements and verdicts."""
        eng = self.engines[0]
        lead = self.rank in self.leaders
        return {
            "cap": self.capacity(eng),
            "stepping": _stepping(eng),
            "busy": bool(eng.busy),
            "steps": stepped,
            "verdicts": verdicts if lead else [],
            "retired": [
                {"family": getattr(r, "family", "llm"), "rid": r.rid,
                 **{k: getattr(r, k) for k in _FILLED if hasattr(r, k)}}
                for r in retired] if lead else [],
        }

    def first_state(self) -> dict:
        return self.local_state([], 0, [])

    def step_local(self, now: float) -> dict:
        """Admit + one step on this rank's replica; its state after."""
        return self.local_state(*_step_one(self.engines[0], now))

    def exchange(self, state: dict, decide):
        """One tick: gather every rank's ``state`` to rank 0, which calls
        ``decide(states)`` (a list by rank); broadcast its result, which
        every rank returns.  An error in ``decide`` is broadcast too, and
        raised on every rank.  The host ms of the two collectives land in
        ``exchange_ms``."""
        t0 = time.perf_counter()
        states = [None] * self.world if self.rank == 0 else None
        dist.gather_object(state, states, dst=0, group=self.group)
        t1 = time.perf_counter()
        msg, err = [None], None
        if self.rank == 0:
            try:
                msg[0] = ("ok", decide(states))
            except BaseException as e:  # every rank must leave the tick
                msg[0], err = ("error", repr(e)), e
        t2 = time.perf_counter()
        dist.broadcast_object_list(msg, src=0, group=self.group)
        self.exchange_ms.append((time.perf_counter() - t2 + t1 - t0) * 1e3)
        kind, body = msg[0]
        if err is not None:
            raise err
        if kind == "error":
            raise RuntimeError(f"the controller on rank 0 failed: {body}")
        return body

    def absorb(self, states: list) -> list:
        """Rank 0: take the leaders' states; returns the requests they
        retired, with the fields their engines filled."""
        self._lead = [states[r] for r in self.leaders]
        done = []
        for st in self._lead:
            self.steps += st["steps"]
            self._tally(st["verdicts"])
            for rec in st["retired"]:
                req = self._inflight.pop((rec["family"], rec["rid"]))
                for k in _FILLED:
                    if k in rec:
                        setattr(req, k, rec[k])
                done.append(req)
        return done

    def place(self, caps: list) -> list:
        placed = super().place(caps)
        for req, _ in placed:
            self._inflight[(getattr(req, "family", "llm"), req.rid)] = req
        return placed

    def capacities(self) -> list:
        """The leaders' capacity records from the last exchange."""
        return [st["cap"] for st in self._lead]

    @property
    def stepping(self) -> bool:
        return any(st["stepping"] for st in self._lead)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(st["busy"] for st in self._lead)

    def collect(self, objs: list) -> list:
        """Every rank's ``objs`` (one item here), in rank order, on every
        rank: a collective over the control group."""
        every = [None] * self.world
        dist.all_gather_object(every, objs, group=self.group)
        return [o for per_rank in every for o in per_rank]

    def from_root(self, obj):
        """``obj`` as rank 0 holds it, on every rank."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


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

    Under a process group of W > 1 ranks (one process a card, ``params``
    on this rank's device) the replicas span ranks instead: the ranks are
    carved by ``replica_meshes``, this rank builds only its own replica's
    engine, on its replica's mesh, and a ``RankReplicaSet`` puts the
    shared queue and the dispatch on rank 0 over a gloo group.  Every rank
    calls every method, with the same arguments; ``run`` returns the
    report on rank 0 and None on the others, and ``n_chips`` is W.
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

        def engine(p, mesh=None):
            return ContinuousBatcher(
                cfg, p, n_slots=n_slots, cache_len=cache_len,
                prefill_chunk=prefill_chunk, prefill_buckets=buckets,
                rns_verify=rns_verify, mesh=mesh,
                page_size=page_size, n_pages=n_pages,
                prefix_share=prefix_share,
                crypto_slots=crypto_slots, crypto_ctx=crypto_ctx,
                crypto_chunk=crypto_chunk,
            )

        home = params["embed"].device
        W = _world()
        self._census_ok = [True]  # each process's census held, last run
        if W > 1:
            meshes = replica_meshes(replicas, home.type)
            replica = dist.get_rank() // (W // replicas)
            control = (None if dist.get_backend() == "gloo"
                       else dist.new_group(backend="gloo"))
            self.devices = [home]
            self.engines = [engine(params, meshes[replica])]
            self.replica_set = RankReplicaSet(
                self.engines[0], replica, replicas, group=control)
            self.n_chips = W
        else:
            self.devices = replica_devices(
                replicas, [home] if home.type == "cpu" else None)
            self.engines = [
                engine(params if dev == home else
                       _tree.tree_map(lambda t: t.to(dev), params))
                for dev in self.devices
            ]
            self.replica_set = ReplicaSet(self.engines)
            self.n_chips = len(set(self.devices))
        self.replicas = int(replicas)
        self.cache_len = int(cache_len)
        self.buckets = self.engines[0].prefill_buckets
        self.overlap = bool(overlap)
        self.queue_size = int(queue_size)
        self.callback = callback if callback is not None else \
            default_callback
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

        for ei, eng in zip(self.replica_set.mine, self.engines):
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
        rs = self.replica_set
        every = rs.collect([dict(s) for s in self._warm_sizes])
        return {
            "replicas": self.replicas,
            "warmed_plens": self._warm_llm_plens(),
            "jit_traces": [every[r] for r in rs.leaders],
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
        if not all(self._census_ok):
            bad = [r for r, ok in enumerate(self._census_ok) if not ok]
            raise RuntimeError(f"steady state retraced on rank(s) {bad} "
                               f"in the last run")

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
                if rs.controller and self.overlap else None)
        inline: list = []
        cursor, wall = [0], [0.0]
        n = len(reqs)
        steps0, ticks0 = rs.steps, len(rs.exchange_ms)
        state = rs.first_state()
        t0 = clock()

        def decide(states):
            # the controller's half of a tick: the last step's retirements
            # into the completions, an idle nap until the next open-loop
            # arrival (short: an admission may free up before it), the
            # arrivals due into the shared queue, then either the end of
            # the run or a dispatch on the capacities after the last step
            i = cursor[0]
            retired = rs.absorb(states)
            for r in retired:
                if pump is not None:
                    pump.put(r)
                else:
                    inline.append((r, self.callback(r)))
            if not retired and not rs.stepping and i < n:
                gap = reqs[i].arrival - (clock() - t0)
                if gap > 0:
                    time.sleep(min(gap, 5e-4))
            now = clock() - t0
            while i < n and reqs[i].arrival <= now:
                rs.submit(reqs[i])
                i += 1
            cursor[0] = i
            if not (i < n or rs.busy):
                if pump is not None:
                    pump.flush()  # completion work counts inside the wall
                wall[0] = clock() - t0
                return [], now, True
            return rs.place(rs.capacities()), now, False

        try:
            while True:
                placed, now, done = rs.exchange(state, decide)
                if done:
                    break
                rs.deliver(placed)
                if on_step is not None:
                    on_step()
                state = rs.step_local(now)
        finally:
            if pump is not None:
                pump.close(raise_error=False)
        every = rs.collect([
            dict(self._stats(e), ok=e.jit_cache_sizes() == w)
            for e, w in zip(self.engines, self._warm_sizes)])
        self._census_ok = [st["ok"] for st in every]
        ticks = rs.exchange_ms[ticks0:]
        if not rs.controller:
            self.completions = []
            return None
        self.completions = list(pump.completed) if pump is not None \
            else inline
        report = self._report(wall[0], steps0, pump,
                              [every[r] for r in rs.leaders],
                              self.steady_state_ok())
        if ticks:
            report["control"] = {"exchanges": len(ticks),
                                 "exchange_ms": sample_stats(ticks)}
        return report

    def _stats(self, eng) -> dict:
        """One replica's census and counters for the report."""
        return {"census": dict(eng.jit_cache_sizes()),
                "buckets": (eng.bucket_stats()
                            if self.buckets is not None else None),
                "paging": eng.page_stats() if eng.paged else None}

    def from_root(self, obj):
        """``obj`` as rank 0 holds it, on every rank (a broadcast over the
        control group); ``obj`` itself in one process."""
        return self.replica_set.from_root(obj)

    def _report(self, wall: float, steps0: int, pump, stats: list,
                retrace_free: bool) -> dict:
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
            "replicas": self.replicas,
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
            "retrace_free": retrace_free,
            "jit_traces": [st["census"] for st in stats],
        }
        if self.buckets is not None:
            agg = {
                "widths": list(self.buckets),
                "hits": {str(b): 0 for b in self.buckets},
                "fallbacks": 0, "pad_tokens": 0, "real_tokens": 0,
            }
            for st in (x["buckets"] for x in stats):
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
            report["paging"] = [st["paging"] for st in stats]
        return report
