"""The port's paged, prefix-sharing KV pool (``repro_torch.serve.scheduler``'s
``PageAllocator``/``PrefixRegistry``/``PagedScheduler``,
``models.attention.attn_decode_paged``, the paged decode/extend stack,
``serve_step.paged_pool_zeros`` and the paged half of ``ContinuousBatcher``)
against the reference's, and against the port's own batched cache.

Everything runs on ``gemma-2b.smoke()`` at the reference's serve geometry
(cache 32, chunk 8, page 8; ``tests/conftest.py``), from the reference's own
``init_params`` carried over with ``params_from_reference``.

Tolerances, by what is compared:

* scheduler state (page tables, refcounts, free and retained lists, the
  registry, action lists, ``page_stats``), tokens, ``verify_log`` and the
  CLI's tick metrics and ``paging`` block: equal;
* f32 logits, attention outputs and pool leaves: rtol 1e-5 plus an atol of
  1e-5 times the largest magnitude, as ``test_torch_serve.py`` states (the
  libraries sum matmuls in other orders);
* per-page fingerprint vectors (f32 sums): the same bound;
* the port's paged engine against its own batched engine (chunk loop and
  bucketed, shared prefix and full-prefix copy-on-write): tokens equal and
  every logical K/V row equal bit for bit on this CPU.
"""
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from conftest import CACHE_LEN, CHUNK, N_PG, PAGE
from repro import configs as rconfigs
from repro.models import attention as RA
from repro.models import decode_step as r_decode_step
from repro.models import extend_step as r_extend_step
from repro.models import init_params as r_init_params
from repro.serve import scheduler as RS
from repro.serve.batcher import ContinuousBatcher as RBatcher
from repro_torch import configs
from repro_torch.models import attention as TA
from repro_torch.models import (decode_step, extend_step,
                                params_from_reference)
from repro_torch.models import transformer as TT
from repro_torch.serve import scheduler as TS
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.serve_step import paged_pool_zeros

ROOT = Path(__file__).resolve().parents[1]
BUCKETS = (8, 16, 32)


def close(got, want, rtol=1e-5):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.fixture(scope="module")
def models():
    """gemma-2b.smoke() in both packages from the reference's params."""
    rc = rconfigs.get_config("gemma-2b").smoke()
    tc = configs.get_config("gemma-2b").smoke()
    rp = r_init_params(rc, jax.random.key(0))
    tp = params_from_reference(tc, jax.tree_util.tree_map(np.asarray, rp),
                               "cpu")
    return rc, rp, tc, tp


def make_engine(cfg, params, *, paged=True, engine=ContinuousBatcher, **kw):
    """The reference conftest's ``make_engine`` geometry."""
    kw.setdefault("n_slots", 3)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("prefill_chunk", CHUNK)
    if paged:
        kw.setdefault("page_size", PAGE)
    return engine(cfg, params, **kw)


def prefix_reqs(mod, vocab, n, plen, shared, max_new, seed=3):
    """n requests whose prompts share a ``shared``-token common prefix."""
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, vocab, shared)]
    return [mod.Request(rid=i, prompt=prefix + [int(t) for t in rng.integers(
        1, vocab, plen - shared)], max_new=max_new) for i in range(n)]


def mixed_reqs(mod, vocab):
    """Shared-prefix traffic, unrelated prompts, and a full-prefix hit
    (a bare prefix: the copy-on-write case)."""
    reqs = prefix_reqs(mod, vocab, 3, plen=19, shared=16, max_new=6)
    rng = np.random.default_rng(29)
    reqs += [mod.Request(rid=10 + i, prompt=[int(t) for t in rng.integers(
        1, vocab, p)], max_new=6) for i, p in enumerate((5, 11, 23))]
    reqs.append(mod.Request(rid=20, prompt=list(reqs[0].prompt[:16]),
                            max_new=5))
    return reqs


def logical_rows(cache, table_row):
    """One slot's logical (L, cache_len, g, hd) K/V rows gathered out of a
    paged pool through a page-table row."""
    pages = torch.as_tensor(list(table_row))
    out = []
    for name in ("k", "v"):
        pool = cache[name]
        L, _, page, g, hd = pool.shape
        out.append(pool[:, pages].reshape(L, len(pages) * page, g, hd))
    return out


def run_with_row_snapshots(eng, reqs):
    """Submit ``reqs``, run to completion, and keep each request's written
    K/V span [0, plen + n_out - 1) as it stands at retirement, on either
    layout.  Returns ({rid: request}, {rid: (k rows, v rows)})."""
    rows = {}
    orig = eng.sched.record_token

    def spy(slot, token, now=0.0):
        req, idx = slot.req, slot.index
        done = orig(slot, token, now)
        if done:
            end = len(req.prompt) + len(req.out) - 1
            if eng.paged:
                k, v = logical_rows(eng.cache, eng.sched.table[idx])
                rows[req.rid] = (k[:, :end].clone(), v[:, :end].clone())
            else:
                rows[req.rid] = tuple(eng.cache[n][:, idx, :end].clone()
                                      for n in ("k", "v"))
        return done

    eng.sched.record_token = spy
    try:
        for r in reqs:
            eng.submit(r)
        done = eng.run_to_completion()
    finally:
        eng.sched.record_token = orig
    return {r.rid: r for r in done}, rows


# ------------------------------------------------------------- schedulers
def drive_scheduler(mod, seed, *, buckets, prefix_share, n_pages):
    """The engine's host half on ``mod``'s PagedScheduler, from one seeded
    operation sequence: submissions over two shared prefixes, admission,
    the prefill write barrier (chunk loop or bucketed with a scratch page),
    registration, decode steps and retirements.  Returns the log of every
    action list and the scheduler's whole state after each tick."""
    rng = np.random.default_rng(seed)
    s = mod.PagedScheduler(3, CACHE_LEN, page_size=PAGE, n_pages=n_pages,
                           prefill_chunk=4, prefix_share=prefix_share,
                           prefill_buckets=buckets)
    prefixes = [[int(t) for t in rng.integers(1, 40, 16)] for _ in range(2)]
    log, rid = [], 0

    def state():
        reg = s.registry
        return {
            "table": [list(r) for r in s.table],
            "refcount": list(s.alloc.refcount),
            "free": list(s.alloc.free),
            "retained": list(s.alloc.retained),
            "reserved": s.alloc.reserved,
            "slots": [(sl.state, sl.next_pos, sl.last_token,
                       sl.prefill_start, sl.reserved_left,
                       None if sl.req is None else sl.req.rid)
                      for sl in s.slots],
            "queue": [q.rid for q in s.queue],
            "nodes": None if reg is None else sorted(
                (str(k), v) for k, v in reg.nodes.items()),
            "page_stats": s.page_stats(),
        }

    for tick in range(48):
        if rng.random() < 0.6:
            pre = prefixes[int(rng.integers(2))][:int(rng.integers(0, 17))]
            tail = [int(t) for t in rng.integers(
                1, 40, int(rng.integers(0 if pre else 1, 7)))]
            prompt = pre + tail
            max_new = int(rng.integers(1, CACHE_LEN - len(prompt) + 1))
            s.submit(mod.Request(rid=rid, prompt=prompt, max_new=max_new))
            rid += 1
        while (slot := s.admit_next(float(tick))) is not None:
            prompt = slot.req.prompt
            start, plen = slot.prefill_start, len(prompt)
            need = plen - start
            if s.bucket_for(need) is not None:
                log.append(("span", s.plan_write(slot, start, need)))
                scratch, acts = s.alloc_scratch(slot)
                log.append(("scratch", scratch, acts))
                s.free_scratch(scratch)
            else:
                for s0 in range(start, plen, 4):
                    log.append(("chunk", s0, s.plan_write(slot, s0, 4)))
            s.register_prompt(slot, prompt)
            idx = slot.index
            if s.start_decode(slot, int(rng.integers(1, 40)), float(tick)):
                log.append(("release", s.release_pages(idx)))
        decoding = s.decoding_slots()
        for slot in decoding:
            log.append(("decode", slot.index,
                        s.plan_write(slot, slot.next_pos, 1)))
        log.append(("rows", s.step_rows()))
        for slot in decoding:
            s.advance(slot)
            idx = slot.index
            if s.record_token(slot, int(rng.integers(1, 40)), float(tick)):
                log.append(("release", s.release_pages(idx)))
        log.append(("state", state()))
    log.append(("completed", [(r.rid, r.out) for r in s.completed]))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("buckets,prefix_share,n_pages", [
    (None, True, 13), (BUCKETS, True, 13), (None, False, 13),
    (BUCKETS, True, N_PG + 2),   # a small pool: deferrals and evictions
])
def test_paged_scheduler_matches_reference(seed, buckets, prefix_share,
                                           n_pages):
    """Both packages' schedulers on one random operation sequence: every
    action list, table, refcount, free/retained list, registry node and
    ``page_stats`` equal, tick by tick."""
    got = drive_scheduler(TS, seed, buckets=buckets,
                          prefix_share=prefix_share, n_pages=n_pages)
    want = drive_scheduler(RS, seed, buckets=buckets,
                           prefix_share=prefix_share, n_pages=n_pages)
    assert got == want
    stats = got[-2][1]["page_stats"]
    assert stats["pages_allocated"] > 0
    if prefix_share:
        assert stats["dedup_hits"] > 0


def test_allocator_and_registry_match_reference():
    """``PageAllocator``/``PrefixRegistry`` on the reference's doctest
    traces and their error paths, in both packages."""
    out = []
    for mod in (TS, RS):
        al = mod.PageAllocator(5)
        trace = [al.alloc(), al.alloc()]
        al.ref(1)
        trace += [al.deref(1, retain=True), al.deref(1, retain=True),
                  al.deref(2, retain=False)]
        trace += [al.alloc() for _ in range(4)]
        trace += [al.in_use, al.available, dict(al.stats)]
        with pytest.raises(RuntimeError, match="exhausted"):
            al.alloc()
        al2 = mod.PageAllocator(4)
        al2.adopt_retained(2)
        trace += [al2.alloc() for _ in range(3)]
        with pytest.raises(ValueError, match="not free"):
            al2.adopt_retained(1)
        reg = mod.PrefixRegistry(page_size=2)
        reg.add(None, (5, 6), pid=3)
        reg.add(3, (7, 8), pid=4)
        trace += [reg.match([5, 6, 7, 8, 9]), reg.match([5, 6, 1, 2])]
        reg.drop(3)
        reg.add(None, (9, 9), pid=3)
        trace += [reg.match([9, 9, 7, 8]), sorted(reg.by_pid)]
        s = mod.PagedScheduler(2, 16, page_size=4, n_pages=6,
                               prefill_chunk=4)
        s.adopt_page(2, None, (1, 2, 3, 4))
        trace += [s.registry.match([1, 2, 3, 4, 5]), s.alloc.is_retained(2)]
        with pytest.raises(ValueError, match="parents-first"):
            s.adopt_page(3, 9, (5, 6, 7, 8))
        out.append(trace)
    assert out[0] == out[1]


# --------------------------------------------------------- paged attention
def paged_case(rng, *, b, s, n_pg, page, P, g, hd):
    k_pool = rng.standard_normal((P, page, g, hd)).astype(np.float32)
    v_pool = rng.standard_normal((P, page, g, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))[:b * n_pg].reshape(b, n_pg)
    return k_pool, v_pool, perm.astype(np.int32)


@pytest.mark.parametrize("case", ["decode", "decode_window", "padded",
                                  "padded_past_row"])
def test_attn_decode_paged_matches_reference(case):
    """``attn_decode_paged`` against the reference's on seeded pools and
    page tables: the output and both pools.  Decode: per-row positions with
    one row parked (its table row unmapped, writing page 0); padded: one
    row's bucketed chunk with its pads on a scratch page, once with the
    pads running past the logical row."""
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    d, h, g, hd, page, n_pg, P = 32, 4, 2, 16, 8, 4, 16
    pw = {"wq": rng.standard_normal((d, h, hd)) * 0.2,
          "wk": rng.standard_normal((d, g, hd)) * 0.2,
          "wv": rng.standard_normal((d, g, hd)) * 0.2,
          "wo": rng.standard_normal((h, hd, d)) * 0.2}
    pw = {k: v.astype(np.float32) for k, v in pw.items()}
    kw = dict(page_size=page, heads=h, kv=g, hd=hd, theta=10000.0)
    if case.startswith("decode"):
        b, s = 3, 1
        k_pool, v_pool, pages = paged_case(rng, b=b, s=s, n_pg=n_pg,
                                           page=page, P=P, g=g, hd=hd)
        pages[2] = 0                                    # a parked row
        pos = np.array([5, 17, n_pg * page - 1])
        extra = {}
        if case == "decode_window":
            kw["window"] = 6
    else:
        b, s = 1, 8
        k_pool, v_pool, pages = paged_case(rng, b=b, s=s, n_pg=n_pg,
                                           page=page, P=P, g=g, hd=hd)
        start = 10 if case == "padded" else n_pg * page - 5
        pos = np.array([start])
        extra = {"valid_len": 3 if case == "padded" else 5,
                 "scratch": P - 1}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    want, wk, wv = jax.jit(lambda p, x, kp, vp, pg, ps: RA.attn_decode_paged(
        p, x, kp, vp, pg, ps, **kw,
        **{k: jnp.int32(v) for k, v in extra.items()}))(
        {k: jnp.asarray(v) for k, v in pw.items()}, jnp.asarray(x),
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(pages),
        jnp.asarray(pos, jnp.int32))
    tk, tv = torch.from_numpy(k_pool.copy()), torch.from_numpy(v_pool.copy())
    got, gk, gv = TA.attn_decode_paged(
        {k: torch.from_numpy(v) for k, v in pw.items()}, torch.from_numpy(x),
        tk, tv, torch.from_numpy(pages).long(), pos.tolist(), **kw, **extra)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    assert gk is tk and gv is tv   # written in place


def test_write_past_the_row_only_for_pads():
    """Pads may run past the logical row (they go to the scratch page); a
    real token past the row is refused on the host before anything is
    written."""
    tc = configs.get_config("gemma-2b").smoke()
    from repro_torch.models import init_params
    params = init_params(tc, 0, "cpu")
    pool = paged_pool_zeros(tc, 6, PAGE, "cpu")
    pages = torch.tensor([[1, 2, 3, 4]])
    toks = torch.ones(1, 8, dtype=torch.int64)
    before = pool["k"].clone()
    with pytest.raises(ValueError, match="leaves the cache row"):
        extend_step(tc, params, pool, toks, 27, pages=pages, page_size=PAGE,
                    valid_len=6, scratch=5)
    assert torch.equal(pool["k"], before)
    logits, pool = extend_step(tc, params, pool, toks, 27, logit_index=4,
                               pages=pages, page_size=PAGE, valid_len=5,
                               scratch=5)
    assert logits.shape == (1, 1, tc.vocab)
    assert torch.equal(pool["k"][:, 0], before[:, 0])   # parking untouched
    with pytest.raises(ValueError, match="leaves the cache row"):
        decode_step(tc, params, pool, toks[:, :1], [CACHE_LEN], pages=pages,
                    page_size=PAGE)
    with pytest.raises(ValueError, match="paged-pool construct"):
        extend_step(tc, params, {"k": pool["k"], "v": pool["v"], "len": 0},
                    toks, 0, valid_len=4)


@pytest.mark.parametrize("arch,window_cache", [("gemma-2b", None),
                                               ("gemma3-1b", False)])
def test_paged_decode_and_extend_match_reference(arch, window_cache):
    """The paged stack (``decode_step``/``extend_step`` with ``pages``) on
    both packages from one pool: a chunk extend, a bucketed extend with
    ``valid_len``/``scratch``, and two decode steps with a parked row;
    logits and every pool leaf to the module's bound."""
    import dataclasses

    rc = rconfigs.get_config(arch).smoke()
    tc = configs.get_config(arch).smoke()
    if window_cache is not None:
        rc = dataclasses.replace(rc, window_cache=window_cache)
        tc = dataclasses.replace(tc, window_cache=window_cache)
    rp = r_init_params(rc, jax.random.key(4))
    tp = params_from_reference(tc, jax.tree_util.tree_map(np.asarray, rp),
                               "cpu")
    rng = np.random.default_rng(8)
    P = 13
    pool = paged_pool_zeros(tc, P, PAGE, "cpu")
    rpool = {"k": jnp.zeros(pool["k"].shape, jnp.float32),
             "v": jnp.zeros(pool["v"].shape, jnp.float32),
             "len": jnp.int32(0)}
    table = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], np.int32)
    steps = [
        ("extend", 0, rng.integers(1, tc.vocab, (1, 8)), None, 0),
        ("extend", 1, rng.integers(1, tc.vocab, (1, 8)), 5, 11),
        ("decode", None, rng.integers(1, tc.vocab, (3, 1)), None, None),
        ("decode", None, rng.integers(1, tc.vocab, (3, 1)), None, None),
    ]
    pos_of = {0: 0, 1: 3}
    dec_pos = [[8, 8, CACHE_LEN - 1], [9, 9, CACHE_LEN - 1]]
    for kind, row, toks, valid, scratch in steps:
        if kind == "extend":
            pg = table[row:row + 1]
            kw = {} if valid is None else {"valid_len": valid,
                                           "scratch": scratch}
            want, rpool = jax.jit(lambda p, c, t, pg: r_extend_step(
                rc, p, c, t, jnp.int32(pos_of[row]), pages=pg,
                page_size=PAGE,
                **{k: jnp.int32(v) for k, v in kw.items()}))(
                rp, rpool, jnp.asarray(toks, jnp.int32), jnp.asarray(pg))
            got, pool = extend_step(tc, tp, pool, torch.from_numpy(toks),
                                    pos_of[row], pages=torch.from_numpy(pg),
                                    page_size=PAGE, **kw)
        else:
            p = dec_pos.pop(0)
            want, rpool = jax.jit(lambda pr, c, t, ps, pg: r_decode_step(
                rc, pr, c, t, ps, pages=pg, page_size=PAGE))(
                rp, rpool, jnp.asarray(toks, jnp.int32),
                jnp.asarray(p, jnp.int32), jnp.asarray(table))
            got, pool = decode_step(tc, tp, pool, torch.from_numpy(toks), p,
                                    pages=torch.from_numpy(table),
                                    page_size=PAGE)
        close(got, want)
        # the scratch page and the parking page take pads and idle rows'
        # junk; every other page is compared
        live = [i for i in range(P) if i not in (0, 11)]
        for name in ("k", "v"):
            close(pool[name][:, live], np.asarray(rpool[name])[:, live])
    assert pool["len"] == int(rpool["len"])


# ------------------------------------------------- paged equals monolithic
@pytest.mark.parametrize("buckets", [None, BUCKETS])
@pytest.mark.parametrize("chunk", [CHUNK, 4])
def test_paged_equals_batched_bit_for_bit(models, buckets, chunk):
    """The port's paged engine (chunk loop or bucketed, chunk 8 or 4)
    against its own batched chunk-loop engine on shared-prefix traffic
    with a full-prefix hit: tokens equal, and every request's logical K/V
    rows over its written span equal bit for bit.  At chunk 4 the
    full-prefix hit restarts mid-page and copies the shared page."""
    _, _, tc, tp = models
    paged = make_engine(tc, tp, prefill_chunk=chunk, prefill_buckets=buckets,
                        rns_verify=True)
    done_p, rows_p = run_with_row_snapshots(paged, mixed_reqs(TS, tc.vocab))
    mono = make_engine(tc, tp, paged=False, rns_verify=True)
    done_m, rows_m = run_with_row_snapshots(mono, mixed_reqs(TS, tc.vocab))
    assert sorted(done_p) == sorted(done_m)
    for rid, r in done_p.items():
        assert r.out == done_m[rid].out, rid
        for a, b in zip(rows_p[rid], rows_m[rid]):
            assert a.shape == b.shape and torch.equal(a, b), rid
    st = paged.page_stats()
    assert st["dedup_hits"] >= 2 * (16 // PAGE)
    assert st["cow_copies"] == (1 if chunk < PAGE else 0)
    assert st["pages_in_use"] == 0 and st["fingerprints"]["failed"] == 0
    assert all(paged.verify_log.values()) and len(paged.verify_log) == 7
    sizes = paged.jit_cache_sizes()
    assert sizes["decode"] == 1 and sizes["fingerprint"] == 1
    assert sizes["copy"] == (1 if chunk < PAGE else 0)


# -------------------------------------------- engine parity with reference
@pytest.mark.parametrize("buckets,chunk", [(None, CHUNK), (BUCKETS, 4)])
def test_paged_engine_matches_reference(models, buckets, chunk):
    """Both packages' paged engines on the same traffic under rns_verify:
    tokens and slots equal, ``page_stats`` equal (the wire counters too),
    ``verify_log`` equal, the census's keys and values equal, and each
    retained page's fingerprint to the f32 bound."""
    rc, rp, tc, tp = models
    out = {}
    for k, (Eng, mod, cfg, params) in {
            "r": (RBatcher, RS, rc, rp), "t": (ContinuousBatcher, TS, tc, tp),
    }.items():
        eng = make_engine(cfg, params, engine=Eng, prefill_chunk=chunk,
                          prefill_buckets=buckets, rns_verify=True)
        for r in mixed_reqs(mod, cfg.vocab):
            eng.submit(r)
        eng.run_to_completion()
        fps = {pid: np.asarray(eng._fp_fn(
                   eng.cache, *((jnp.int32(pid),
                                 jnp.int32(eng._page_span[pid])) if k == "r"
                                else (pid, eng._page_span[pid]))))
               for pid in sorted(eng.wire.keys())}
        out[k] = ({r.rid: (r.out, r.slot_index) for r in
                   eng.sched.completed}, eng.page_stats(),
                  dict(eng.verify_log), eng.jit_cache_sizes(), fps,
                  dict(eng._page_pub), [list(r) for r in eng.sched.table])
    for i in (0, 1, 2, 3, 5, 6):
        assert out["t"][i] == out["r"][i], i
    assert sorted(out["t"][4]) == sorted(out["r"][4]) != []
    for pid, want in out["r"][4].items():
        close(torch.from_numpy(out["t"][4][pid]), want)


def test_paged_sim_cli_matches_reference_cli(tmp_path):
    """``--page-size`` in both packages' serve CLI: the tick metrics, the
    ``paging`` block and the RRNS block (an injected fault on a retained
    page detected, repaired once, re-verified) equal."""
    argv = ["--arch", "gemma-2b", "--requests", "6", "--slots", "3",
            "--cache-len", "64", "--prefill-chunk", "8", "--max-new", "6",
            "--page-size", "16", "--rns-verify", "--inject-wire-corrupt"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    runs = [subprocess.run([sys.executable, "-m", mod, *extra, *argv],
                           env=env, cwd=tmp_path, capture_output=True,
                           text=True, timeout=600)
            for mod, extra in (("repro_torch.launch.serve",
                                ["--device", "cpu"]),
                               ("repro.launch.serve", []))]
    for r in runs:
        assert r.returncode == 0, r.stderr
    g, w = (json.loads(r.stdout) for r in runs)
    for key in ("requests", "tokens_out", "steps", "max_concurrency",
                "ttft_ticks", "latency_ticks", "jit_traces", "paging",
                "rns"):
        assert g[key] == w[key], key
    assert g["rns"]["injected_repair"] == {"repaired": 1, "unrecoverable": 0}
    assert g["rns"]["injected_reverified"]


# ---------------------------------------------------------- page counts
def test_75pct_shared_prefix_uses_strictly_fewer_pages(models):
    """8 requests sharing a 75%-length prefix peak at strictly fewer
    physical pages than 8 batched rows hold, under one decode signature."""
    _, _, tc, tp = models
    n = 8
    eng = make_engine(tc, tp, n_slots=n, n_pages=1 + n * N_PG)
    for r in prefix_reqs(TS, tc.vocab, n, plen=24, shared=18, max_new=8):
        eng.submit(r)
    eng.try_admit()
    assert len(eng.sched.decoding_slots()) == n
    eng.run_to_completion()
    st = eng.page_stats()
    assert st["pages_in_use_peak"] < n * N_PG
    assert st["dedup_hits"] >= (n - 1) * (18 // PAGE)
    sizes = eng.jit_cache_sizes()
    assert sizes["decode"] == 1 and sizes["extend"] == 1


def test_admission_defers_on_page_pressure(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=4, n_pages=N_PG + 2)
    for i in range(4):
        eng.submit(TS.Request(rid=i, prompt=[i * 7 + 1] * 12, max_new=6))
    assert len(eng.run_to_completion()) == 4
    st = eng.page_stats()
    assert st["deferrals"] > 0 and st["pages_in_use"] == 0


# ------------------------------------------------------- shared-page faults
def test_shared_page_corruption_repaired_once_for_all_readers(models):
    """The one stored codeword of a page shared by three readers, corrupted:
    detected by the redundant channels, repaired in place once, and every
    reader's retirement verification passes against the fixed codeword."""
    _, _, tc, tp = models
    rng = np.random.default_rng(7)
    prefix = [int(t) for t in rng.integers(1, tc.vocab, PAGE)]
    eng = make_engine(tc, tp, rns_verify=True)
    for i in range(3):
        eng.submit(TS.Request(rid=i, prompt=prefix + [40 + i], max_new=4))
    eng.try_admit()
    shared = [p for p in range(eng.n_pages)
              if eng.sched.alloc.refcount[p] > 1]
    assert len(shared) == 1
    pid = shared[0]
    assert pid in eng.wire
    eng.corrupt_wire(pid, channel=1, delta=3)
    assert not eng.wire_ok(pid)
    assert eng.repair_wire(pid) == {"repaired": 1, "unrecoverable": 0}
    assert eng.wire_ok(pid)
    eng.run_to_completion()
    assert eng.verify_log == {0: True, 1: True, 2: True}
    assert eng.wire.stats["repaired"] == 1
    assert eng.wire.stats["failed"] == 0


def test_eviction_verify_failure_lands_in_verify_log(models):
    """Retained pages' stored codewords corrupted, then evicted under pool
    pressure: the mismatch lands in verify_log under the publisher rids."""
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, n_pages=N_PG + 2, rns_verify=True)
    eng.submit(TS.Request(rid=0, prompt=[2] * 12, max_new=6))
    eng.submit(TS.Request(rid=1, prompt=[5] * 12, max_new=6))
    eng.run_to_completion()
    assert eng.verify_log == {0: True, 1: True}
    retained = list(eng.sched.alloc.retained)
    assert retained
    pubs = {eng._page_pub[pid] for pid in retained}
    for pid in retained:
        eng.corrupt_wire(pid, channel=1, delta=3)
    for i in (2, 3):
        eng.submit(TS.Request(rid=i, prompt=[i * 3 + 2] * 12, max_new=6))
    eng.run_to_completion()
    assert eng.page_stats()["pages_evicted"] >= 1
    bad = [r for r, ok in eng.verify_log.items() if not ok]
    assert bad and set(bad) <= pubs
    assert eng.wire.stats["failed"] >= 1


def test_eviction_and_reuse_keep_fingerprints_valid(models):
    _, _, tc, tp = models
    eng = make_engine(tc, tp, n_slots=2, n_pages=N_PG + 2, rns_verify=True)
    for i in range(4):
        eng.submit(TS.Request(rid=i, prompt=[i * 3 + 2] * 12, max_new=6))
    eng.run_to_completion()
    st = eng.page_stats()
    assert st["pages_evicted"] >= 1
    assert all(eng.verify_log.values())
    assert st["fingerprints"]["failed"] == 0
    assert st["fingerprints"]["verified"] > 0


# --------------------------------------------------------- duplicate writes
def test_duplicate_write_targets_land_on_parking_or_scratch(models):
    """Every duplicate (page, offset) in one call's write set lands on the
    parking page 0 or on that call's scratch page: an index write with
    duplicate targets keeps one of them (on the card, any one), so no live
    page may ever receive two.  Checked on every call of a bucketed run
    with idle rows, pads longer than a page, shared prefixes and a
    full-prefix hit."""
    _, _, tc, tp = models
    calls = []
    orig = TT.paged_targets

    def spy(pages, positions, page_size, valid_len=None, scratch=None):
        pid, off = orig(pages, positions, page_size, valid_len, scratch)
        calls.append((pid.clone(), off.clone(), scratch))
        return pid, off

    TT.paged_targets = spy
    try:
        eng = make_engine(tc, tp, n_slots=4, prefill_chunk=4,
                          prefill_buckets=(8, 32), rns_verify=True)
        for r in mixed_reqs(TS, tc.vocab):
            eng.submit(r)
        eng.run_to_completion()
    finally:
        TT.paged_targets = orig
    assert all(eng.verify_log.values())
    dup_calls = 0
    for pid, off, scratch in calls:
        pairs = Counter(zip(pid.flatten().tolist(), off.flatten().tolist()))
        dups = {p for (p, _), n in pairs.items() if n > 1}
        dup_calls += bool(dups)
        assert dups <= {0, scratch}, (dups, scratch)
    assert dup_calls > 0   # the run did make duplicates, where allowed


def test_bucket_pads_write_only_span_page_and_scratch(models):
    """A bucketed prefill whose bucket overshoots the prompt and the row
    (pads past cache_len) touches only the slot's own span page and the
    scratch page; every other physical page is byte-identical."""
    _, _, tc, tp = models
    rng = np.random.default_rng(23)
    prefix = [int(t) for t in rng.integers(1, tc.vocab, 16)]
    eng = make_engine(tc, tp, prefill_buckets=(32,), rns_verify=True)
    eng.submit(TS.Request(rid="pub", prompt=prefix + [7, 8, 9], max_new=2))
    eng.run_to_completion()
    before = {n: eng.cache[n].clone() for n in ("k", "v")}
    reg_pids = set(eng.sched.registry.by_pid)
    assert reg_pids
    grabbed, orig = [], eng.sched.alloc_scratch

    def spy(slot):
        pid, acts = orig(slot)
        grabbed.append(pid)
        return pid, acts

    eng.sched.alloc_scratch = spy
    try:
        eng.submit(TS.Request(rid="sub", prompt=prefix + [11] * 6,
                              max_new=2))
        eng.try_admit()
    finally:
        eng.sched.alloc_scratch = orig
    assert len(grabbed) == 1
    scratch = grabbed[0]
    row = list(eng.sched.table[eng.sched.decoding_slots()[0].index])
    assert scratch not in row and eng.sched.alloc.refcount[scratch] == 0
    allowed = {row[2], scratch}
    assert reg_pids.isdisjoint(allowed)
    for pid in range(eng.n_pages):
        if pid not in allowed:
            for n in ("k", "v"):
                assert torch.equal(eng.cache[n][:, pid], before[n][:, pid])
    eng.run_to_completion()
    assert all(eng.verify_log.values())


# --------------------------------------------------------------- validation
@pytest.mark.parametrize("kw", [
    dict(page_size=5),
    dict(cache_len=96, page_size=32, prefill_chunk=24),
    dict(n_pages=N_PG + 1),
    dict(page_size=520, cache_len=1040, prefill_chunk=8),
])
def test_capacity_errors_match_reference(models, kw):
    """Each refusal with the reference's own message, naming the derived
    legal values."""
    rc, rp, tc, tp = models
    with pytest.raises(ValueError) as got:
        make_engine(tc, tp, **kw)
    with pytest.raises(ValueError) as want:
        make_engine(rc, rp, engine=RBatcher, **kw)
    assert str(got.value) == str(want.value)
    assert any(w in str(got.value) for w in
               ("page sizes", "minimum n_pages", "nearest legal"))


def test_paged_pool_zeros_shapes():
    """The pool is ``cache_zeros`` with pages for rows (the reference's
    ``paged_pool_abstract``); ring and int8 layouts are refused."""
    import dataclasses

    from repro.serve.serve_step import paged_pool_abstract

    rc = rconfigs.get_config("gemma-2b").smoke()
    tc = configs.get_config("gemma-2b").smoke()
    want = paged_pool_abstract(rc, jax.eval_shape(
        lambda: r_init_params(rc, jax.random.key(0))), 9, PAGE)
    got = paged_pool_zeros(tc, 9, PAGE, "cpu")
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        assert tuple(got[name].shape) == tuple(want[name].shape)
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)
        assert not got[name].any()
    g3 = configs.get_config("gemma3-1b").smoke()
    with pytest.raises(ValueError, match="window_cache=False"):
        paged_pool_zeros(g3, 9, PAGE, "cpu")
    with pytest.raises(ValueError, match="fp-only"):
        paged_pool_zeros(dataclasses.replace(tc, kv_quant=True), 9, PAGE,
                         "cpu")
