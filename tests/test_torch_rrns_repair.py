"""The RRNS repair in one pass (``repro_torch.kernels.rrns_repair``: the
CUDA kernel ``csrc/rrns_repair.cu`` and its plain torch version) against
the all-column survivor scan, ``rrns_repair.survivor_scan`` and the fix.

On the CPU: ``rrns_repair_plain`` (which ``rrns_repair_op`` takes for a
host tensor) on seeded codewords with planted faults; ``emulate_kernel``,
the kernel's arithmetic in numpy with every table word read from the image
at the offset the source computes (the clean test's lazy MRC step and
``mod_mulhi`` with the ranges their exactness needs asserted, the survivor
scan in wrapping int32); the clean test against an independent CRT oracle
and, over every codeword of a small 5-channel base, the equivalence it
rests on (clean => verdict -1); the one route of ``train_step._repair``,
``correct_packed`` and ``locate_fault``: one ``rrns_repair_op`` call each,
the plain version's passes giving the words, verdicts and counts of the
all-column scan.  On the card (marked ``cuda``): the kernel against the
plain version, ``correct_packed`` on the card against the CPU, the refusal
of an operand the kernel does not take, and a wire of 5 x 429,496,730
residues (past 2**31) with faults at its last columns.

The file imports no JAX: it runs as it is on the card's machine.

Tolerance: none.  Residues, verdicts and counts must be equal.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.core.base import RNSBase
from repro_torch.dist.grad_codec import GradCodec
from repro_torch.kernels import build, ops
from repro_torch.kernels import rrns_repair as rr
from repro_torch.kernels.rrns_repair import (LAYOUT_FIELDS, repair_layout,
                                             rrns_repair_kernel_call,
                                             rrns_repair_plain, survivor_scan,
                                             survivor_tables)
from repro_torch.train import train_step as ts

M32 = 0xFFFFFFFF
MAGIC = 0x4B400000
WRAPS = (0, 7)
CASES = ("fault_c0", "fault_c1", "fault_c2", "fault_c3", "fault_c4",
         "two_channels", "redundant_only", "x0_and_m_minus_1",
         "out_of_range")


def eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def rrns_codec():
    return GradCodec.make(world=8, correct=True)


def channels(codec):
    return tuple(codec.base.moduli) + codec.redundant


def codewords(codec, xs):
    """(nch, B) int32 residues of the integers ``xs`` in every channel."""
    xs = np.asarray(xs, np.int64)
    return torch.from_numpy(
        np.stack([xs % m for m in channels(codec)]).astype(np.int32))


def draw(codec, B, wraps, rng):
    """Values in the legitimate range [0, (wraps + 1) M)."""
    return rng.integers(0, (wraps + 1) * codec.base.M, B, dtype=np.int64)


def case_words(codec, case, wraps, seed, B=3000):
    """A seeded (nch, B) codeword buffer for ``case``: faults (a nonzero
    offset, mod the channel's modulus) planted in a tenth of the columns."""
    rng = np.random.default_rng(seed)
    ms = channels(codec)
    xs = draw(codec, B, wraps, rng)
    if case == "x0_and_m_minus_1":
        xs[: B // 2] = 0
        xs[B // 2 :] = codec.base.M - 1
    x = codewords(codec, xs)
    cols = rng.choice(B, B // 10, replace=False)

    def bump(c, at):
        off = torch.from_numpy(rng.integers(1, ms[c], len(at))).to(torch.int32)
        x[c, at] = torch.remainder(x[c, at] + off, ms[c])

    if case.startswith("fault_c"):
        bump(int(case[-1]), cols)
    elif case == "two_channels":
        for k, at in enumerate(np.array_split(cols, 4)):
            a, b = rng.choice(len(ms), 2, replace=False)
            bump(a, at)
            bump(b, at)
    elif case == "redundant_only":
        ra, rb, both = np.array_split(cols, 3)
        bump(3, ra)
        bump(4, rb)
        bump(3, both)
        bump(4, both)
    elif case == "x0_and_m_minus_1":
        for c, at in enumerate(np.array_split(cols, len(ms))):
            bump(c, at)
    elif case == "out_of_range":   # residues no encode makes
        vals = [-1, -(1 << 31), (1 << 31) - 1, 40000, 32768, -32749]
        for k, at in enumerate(np.array_split(cols, 12)):
            c = k % len(ms)
            x[c, at] = vals[k % len(vals)] if k < 6 else ms[c] + k
    return x


def reference(codec, x, wraps):
    """The survivor scan of every column of the (nch, B) words and its
    fix: the fixed words and the verdicts."""
    fault, fixes = survivor_scan(codec, x, wraps)
    rows = torch.arange(x.shape[0], dtype=torch.int32)[:, None]
    hit = fault[None, :] == rows
    return torch.where(hit, fixes, x), fault


def clean_oracle(codec, x) -> np.ndarray:
    """The clean test by Python ints: canonical base residues whose CRT
    value X < M has the carried redundant residues."""
    ms, n, M = channels(codec), codec.base.n, codec.base.M
    out = []
    for col in x.T.tolist():
        if not all(0 <= r < m for r, m in zip(col[:n], ms)):
            out.append(False)
            continue
        X = sum(r * (M // m) * pow(M // m, -1, m)
                for r, m in zip(col[:n], ms)) % M
        out.append(X % ms[n] == col[n] and X % ms[n + 1] == col[n + 1])
    return np.asarray(out)


def image(codec, wraps, device="cpu"):
    return ops._repair_image(codec.base, codec.redundant, wraps,
                             torch.device(device))


# --------------------------------------------------- the kernel in numpy
def signed(u):
    return np.where(u >= 1 << 31, u - (1 << 32), u)


class Words:
    """The image as the kernel reads it: int32 (or uint32, uint16) words at
    byte offsets that must fall inside the staged bytes."""

    def __init__(self, img: np.ndarray):
        self.img = img

    def read(self, off, count=1, dt=np.int32):
        size = np.dtype(dt).itemsize
        assert off % size == 0 and 0 <= off
        assert off + size * count <= self.img.size
        return self.img[off : off + size * count].view(dt).astype(np.int64)


def tables_of(img: np.ndarray, n: int) -> dict:
    """The image's int32 tables, shaped as ``repair_layout`` lists them,
    and the base's triangle rebuilt from its uint16 words."""
    L, W = repair_layout(n), Words(img)
    nch, s = n + 2, n + 1
    shapes = {"mod": (nch,), "beta": (2, n), "smod": (nch, s),
              "sinv": (nch, s, s), "sbeta": (nch, s), "rdig": (nch, s)}
    out = {k: W.read(L[k], math.prod(sh)).reshape(sh)
           for k, sh in shapes.items()}
    inv = np.zeros((n, n), np.int64)
    inv[np.triu_indices(n, 1)] = W.read(L["tri"], n * (n - 1) // 2,
                                        np.uint16)
    out["inv"] = inv
    return out


def lazy_step(c, z, a, inv, m, rc):
    """mrc_warp.cuh's step: z = c - r (mod 2**32), r in (-m, m); the
    ranges of its exactness argument asserted."""
    d = signed((c - z - a) & M32)
    assert (np.abs(d) < 1 << 16).all()
    t = d * inv
    assert (np.abs(t) < 1 << 31).all()
    q = np.rint(t.astype(np.float32).astype(np.float64) * rc)
    u = ((MAGIC + q.astype(np.int64)) * m - t) & M32
    r = signed((c - u) & M32)
    assert (np.abs(r) < m).all() and ((r - t) % m == 0).all()
    return u


def mod_mulhi(t, m, mu):
    """common.cuh::mod_mulhi on uint32 t."""
    assert ((t >= 0) & (t <= M32)).all()
    q = (t.astype(np.uint64) * np.uint64(mu)) >> np.uint64(32)
    r = signed((t - q.astype(np.int64) * m) & M32)
    r = r - np.where(r >= m, m, 0)
    assert ((r >= 0) & (r < m)).all() and ((t - r) % m == 0).all()
    return r


def fmod(t, m):
    """torch.remainder of int32 t by m > 0, as floor_mod computes it from
    C's truncating %."""
    r = np.fmod(t, m)
    return r + np.where(r < 0, m, 0)


def emulate_kernel(x, img: np.ndarray, n: int):
    """csrc/rrns_repair.cu on the (nch, B) words ``x`` (int32 tensor):
    returns (fixed words, verdicts, counts)."""
    L, W = repair_layout(n), Words(img)
    C, S = n + 2, n + 1
    x = x.numpy().astype(np.int64)
    mod = W.read(L["mod"], C)
    m = mod[:n, None]
    mu = W.read(L["mu"], 2, np.uint32)
    rc = (np.float32(1) / m.astype(np.float32)).astype(np.float64)
    canon = ((x[:n] & M32) < m).all(axis=0)
    # rrns_repair_kernel: mrc_thread<N> on the canonical base residues
    w = np.where(canon, x[:n], 0)
    cc = (MAGIC * m) & M32
    z = (cc - w) & M32
    d = np.zeros_like(w)
    for j in range(n):
        a = signed((cc[j] - z[j]) & M32)
        a = a + np.where(a < 0, m[j], 0)
        d[j] = a
        for i in range(j + 1, n):
            idx = j * (2 * n - j - 1) // 2 + i - j - 1
            inv = W.read(L["tri"] + 2 * idx, 1, np.uint16)[0]
            z[i] = lazy_step(cc[i], z[i], a, inv, m[i], rc[i])
    ext = []
    for r in range(2):               # extend<N> into m_a, then m_b
        beta = W.read(L["beta"] + 4 * n * r, n)
        acc = np.zeros(x.shape[1], np.int64)
        for i in range(n):
            acc = acc + d[i] * beta[i]
        ext.append(mod_mulhi(acc, mod[n + r], mu[r]))
    clean = canon & (ext[0] == x[n]) & (ext[1] == x[n + 1])
    verdict = np.full(x.shape[1], -1, np.int64)
    out = x.copy()
    cols = np.nonzero(~clean)[0]          # full_scan<N>, column-wise
    r = x[:, cols]
    cnt = np.zeros(cols.size, np.int64)
    hit, fix = np.zeros_like(cnt), np.zeros_like(cnt)
    wrap = lambda v: signed(v & M32)
    for c in range(C):
        sm = W.read(L["smod"] + 4 * c * S, S)
        inv = W.read(L["sinv"] + 4 * c * S * S, S * S)
        sb = W.read(L["sbeta"] + 4 * c * S, S)
        rd = W.read(L["rdig"] + 4 * c * S, S)
        wk = [r[k] if k < c else r[k + 1] for k in range(S)]
        a = [wk[0]] + [None] * (S - 1)
        for j in range(S - 1):
            for k in range(j + 1, S):
                dd = wrap(wk[k] - a[j])
                dd = np.where(dd < 0, wrap(dd + sm[k]), dd)
                wk[k] = fmod(wrap(dd * inv[j * S + k]), sm[k])
            a[j + 1] = wk[j + 1]
        lt = np.zeros(cols.size, bool)
        done = np.zeros_like(lt)
        for k in range(S - 1, -1, -1):
            ne = (a[k] != rd[k]) & ~done
            lt = np.where(ne, a[k] < rd[k], lt)
            done |= ne
        mc = mod[c]
        acc = np.zeros_like(cnt)
        for k in range(S):
            acc = wrap(acc + fmod(wrap(a[k] * sb[k]), mc))
        first = lt & (cnt == 0)
        hit = np.where(first, c, hit)
        fix = np.where(first, fmod(acc, mc), fix)
        cnt += lt
    v = np.where(cnt == C, -1, np.where(cnt == 1, hit, -2))
    verdict[cols] = v
    sel = v >= 0
    out[v[sel], cols[sel]] = fix[sel]
    counts = [int((verdict >= 0).sum()), int((verdict == -2).sum()),
              int((~clean).sum())]
    return out.astype(np.int32), verdict.astype(np.int32), counts


# ------------------------------------------------------------ the CPU
@pytest.mark.parametrize("wraps", WRAPS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_fault_scan(case, wraps):
    codec = rrns_codec()
    x = case_words(codec, case, wraps, seed=CASES.index(case) + 10 * wraps)
    want, fault = reference(codec, x, wraps)
    got = x.clone()
    counts, verdict = rrns_repair_plain(codec, got, wraps=wraps, verdict=True)
    eq(got, want)
    eq(verdict, fault)
    clean = clean_oracle(codec, x)
    assert counts.dtype == torch.int64
    assert counts.tolist() == [int((fault >= 0).sum()),
                               int((fault == -2).sum()), int((~clean).sum())]
    assert (fault.numpy()[clean] == -1).all()
    if case.startswith("fault_c") and wraps == 0:
        assert int((fault >= 0).sum()) == len(x.T) // 10   # every one fixed
    if case == "two_channels" and wraps == 0:
        assert set(fault.tolist()) == {-1, -2}


@pytest.mark.parametrize("wraps", WRAPS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_emulation_matches_plain(case, wraps):
    codec = rrns_codec()
    x = case_words(codec, case, wraps, seed=100 + CASES.index(case) + wraps)
    img = image(codec, wraps)
    got, verdict, counts = emulate_kernel(x, img.numpy(), codec.base.n)
    want = x.clone()
    want_counts, want_verdict = rrns_repair_plain(codec, want, wraps=wraps,
                                                  verdict=True)
    eq(got, want)
    eq(verdict, want_verdict)
    assert counts == want_counts.tolist()


@pytest.mark.parametrize("wraps", (0, 3, 9))
def test_clean_test_implies_clean_verdict_on_every_codeword(wraps):
    """Every 5-tuple of residues of a small base, (3, 5, 7) with m_a 13 and
    m_b 11: where the clean test passes, ``survivor_scan``'s verdict is -1;
    the plain version equals the all-column scan on every tuple."""
    codec = GradCodec(base=RNSBase(moduli=(3, 5, 7), ma=13, bits=4),
                      frac_bits=0, world=1, mb=11)
    ms = channels(codec)
    grid = np.stack(np.meshgrid(*(np.arange(m) for m in ms), indexing="ij"))
    x = torch.from_numpy(grid.reshape(len(ms), -1).astype(np.int32))
    want, fault = reference(codec, x, wraps)
    got = x.clone()
    counts, verdict = rrns_repair_plain(codec, got, wraps=wraps, verdict=True)
    clean = clean_oracle(codec, x)
    assert clean.sum() == codec.base.M                 # one codeword an X
    assert (fault.numpy()[clean] == -1).all()
    eq(got, want)
    eq(verdict, fault)
    assert counts.tolist() == [int((fault >= 0).sum()),
                               int((fault == -2).sum()), int((~clean).sum())]
    e_got, e_verdict, e_counts = emulate_kernel(x, image(codec, wraps).numpy(),
                                                codec.base.n)
    eq(e_got, want)
    eq(e_verdict, fault)
    assert e_counts == counts.tolist()


def test_image_holds_the_survivor_tables():
    codec = rrns_codec()
    for wraps in WRAPS:
        T = tables_of(image(codec, wraps).numpy(), codec.base.n)
        tables = survivor_tables(codec.base.moduli, codec.redundant,
                                 codec.base.bits, wraps)
        eq(T["mod"], channels(codec))
        eq(T["beta"], codec.base.betas_for(codec.redundant))
        eq(T["inv"], codec.base.inv_tri_np)
        for c, (sb, digits) in enumerate(tables):
            eq(T["smod"][c], sb.moduli)
            eq(T["sinv"][c], sb.inv_tri_np)
            eq(T["sbeta"][c], sb.betas_for((channels(codec)[c],))[0])
            eq(T["rdig"][c], digits)
            assert sum(d * math.prod(sb.moduli[:k])
                       for k, d in enumerate(digits)) \
                == (wraps + 1) * codec.base.M
    L = repair_layout(codec.base.n)
    mu = image(codec, 0).numpy()[L["mu"] : L["mu"] + 8].view(np.uint32)
    eq(mu, [(1 << 32) // m for m in codec.redundant])


def test_layout_fields_match_the_source():
    src = (build._CSRC / "rrns_repair.cu").read_text()
    body = src.split("struct RepairLayout {", 1)[1].split("};", 1)[0]
    fields = [w for w in re.findall(r"\w+", body) if w != "int"]
    assert tuple(fields) == LAYOUT_FIELDS
    assert f"kMaxBase = {rr.MAX_BASE};" in src
    assert "rrns_repair.cu" in build._SOURCES
    for n in range(1, rr.MAX_BASE + 1):
        L = repair_layout(n)
        assert L["image"] % 16 == 0 and L["image"] <= 48 * 1024
        assert L["tri"] + n * (n - 1) <= L["image"]


def test_cpu_op_takes_the_plain_version_and_counts_no_launch():
    ops.reset_launches()
    codec = rrns_codec()
    x = case_words(codec, "fault_c2", 0, seed=5, B=500)
    want = x.clone()
    want_counts, want_verdict = rrns_repair_plain(codec, want, verdict=True)
    counts, verdict = ops.rrns_repair_op(codec, x, verdict=True)
    eq(x, want)
    eq(verdict, want_verdict)
    eq(counts, want_counts)
    assert ops.rrns_repair_op(codec, x)[1] is None
    assert ops.reset_launches()["rrns_repair_op"] == 0


def test_refusals():
    codec = rrns_codec()
    img = image(codec, 0)
    with pytest.raises(ValueError, match="int32"):
        rrns_repair_plain(codec, torch.zeros(5, 3, dtype=torch.int64))
    with pytest.raises(ValueError, match="base channels"):
        rrns_repair_plain(codec, torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="base channels"):
        rrns_repair_plain(codec, torch.zeros(6, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="base channels"):
        rrns_repair_kernel_call(torch.zeros(6, 3, dtype=torch.int32), img)
    with pytest.raises(ValueError, match="image"):
        rrns_repair_kernel_call(torch.zeros(4, 3, dtype=torch.int32), img)
    with pytest.raises(ValueError, match="correct=True"):
        ops.rrns_repair_op(GradCodec.make(world=8),
                           torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="wraps"):
        ops.rrns_repair_op(codec, torch.zeros(5, 3, dtype=torch.int32),
                           wraps=10 ** 9)
    with pytest.raises(ValueError, match="CUDA"):
        rrns_repair_kernel_call(torch.zeros(5, 3, dtype=torch.int32), img)


@pytest.fixture
def op_calls(monkeypatch):
    """The shapes of the codewords ``rrns_repair_op`` is called on, the
    call itself left as it is."""
    calls = []
    real = ops.rrns_repair_op

    def op(*args, **kw):
        calls.append(tuple(args[1].shape))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "rrns_repair_op", op)
    return calls


def test_repair_route_is_one_call_with_the_chunked_bits(op_calls,
                                                        monkeypatch):
    """``train_step._repair`` makes one ``rrns_repair_op`` call over the
    whole wire; the plain version's passes of REPAIR_COLUMNS columns give
    the words, verdicts and counts of the all-column survivor scan."""
    codec = rrns_codec()
    x = case_words(codec, "x0_and_m_minus_1", 0, seed=7, B=1000)
    want_fixed, want_fault = reference(codec, x, 0)
    want = [int((want_fault >= 0).sum()), int((want_fault == -2).sum())]
    monkeypatch.setattr(rr, "REPAIR_COLUMNS", 300)
    passes = x.clone()
    counts, verdict = rrns_repair_plain(codec, passes, verdict=True)
    eq(passes, want_fixed)
    eq(verdict, want_fault)
    assert counts.tolist() == want + [int((~clean_oracle(codec, x)).sum())]
    got = ts._repair(codec, codec.as_array(x, channel_major=True))
    assert op_calls == [(5, 1000)]
    eq(x, want_fixed)
    assert got.dtype == torch.int64 and got.tolist() == want
    assert got.tolist() == [100, 0]


@pytest.mark.parametrize("layout", ("leaf_major", "channel_major_view",
                                    "typed_array"))
def test_correct_and_locate_route_match_fault_scan(op_calls, layout):
    codec = rrns_codec()
    x = case_words(codec, "two_channels", 0, seed=8, B=700)
    x[:, :70] = case_words(codec, "fault_c4", 0, seed=9, B=700)[:, :70]
    if layout == "leaf_major":
        arg = x.T.contiguous()
    elif layout == "channel_major_view":
        arg = x.T
    else:
        arg = codec.as_array(x.clone(), channel_major=True)
    before = x.clone()
    fixed, fault = codec.correct_packed(arg)
    located = codec.locate_fault(arg)
    assert op_calls == [(5, 700)] * 2
    want_fixed, want_fault = reference(codec, x, 0)
    eq(fault, want_fault)
    eq(located, want_fault)
    if layout == "typed_array":
        assert fixed.channel_axis == 0
        eq(fixed.residues, want_fixed)
    else:
        eq(fixed, want_fixed.T)
    eq(x, before)                       # the input is left as it was


# ------------------------------------------------- on the card (skip here)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wraps", WRAPS)
def test_cuda_kernel_matches_plain(card, wraps):
    """2**20 + 3 seeded columns with every case's faults, in place."""
    codec = rrns_codec()
    B = (1 << 20) + 3
    rng = np.random.default_rng(wraps)
    x = codewords(codec, draw(codec, B, wraps, rng))
    parts = np.array_split(np.arange(B), len(CASES))
    for case, part in zip(CASES, parts):
        x[:, part[0] : part[-1] + 1] = case_words(
            codec, case, wraps, seed=int(part[0]), B=len(part))
    x = x.to(card)
    want = x.clone()
    want_counts, want_verdict = rrns_repair_plain(codec, want, wraps=wraps,
                                                  verdict=True)
    ops.reset_launches()
    counts, verdict = ops.rrns_repair_op(codec, x, wraps=wraps, verdict=True)
    torch.cuda.synchronize()
    assert ops.reset_launches()["rrns_repair_op"] == 1
    eq(x, want)
    eq(verdict, want_verdict)
    eq(counts, want_counts)
    strided = want.T.contiguous().T                 # channels-last rows
    plain = want.clone()
    eq(ops.rrns_repair_op(codec, strided, wraps=wraps)[0],
       rrns_repair_plain(codec, plain, wraps=wraps)[0])
    eq(strided, plain)


@pytest.mark.cuda
def test_cuda_correct_packed_matches_cpu(card):
    codec = rrns_codec()
    x = case_words(codec, "two_channels", 0, seed=11, B=50_000)
    for arg in (x.T.contiguous(), x.T):
        ops.reset_launches()
        fixed, fault = codec.correct_packed(arg.to(card))
        assert ops.reset_launches()["rrns_repair_op"] == 1
        want_fixed, want_fault = codec.correct_packed(arg)
        eq(fixed, want_fixed)
        eq(fault, want_fault)
        eq(codec.locate_fault(arg.to(card)), want_fault)
    repaired = ts._repair(codec, codec.as_array(x.to(card), channel_major=True))
    assert repaired.device.type == "cuda"
    assert repaired.tolist() == [int((want_fault >= 0).sum()),
                                 int((want_fault == -2).sum())]


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take(card):
    """On the card the kernel runs or the op raises: a 20-bit base (int64
    lanes), int64 codewords, four base channels."""
    wide = GradCodec.make(world=2, n=2, bits=20, correct=True)
    with pytest.raises(ValueError, match="bits<=15"):
        wide.correct_packed(torch.zeros((3, 4), dtype=torch.int64,
                                        device=card))
    with pytest.raises(ValueError, match="int32"):
        ops.rrns_repair_op(rrns_codec(), torch.zeros((5, 3),
                                                     dtype=torch.int64,
                                                     device=card))
    four = GradCodec.make(world=2, n=4, bits=15, correct=True)
    with pytest.raises(ValueError, match="base channels"):
        four.correct_packed(torch.zeros((3, 6), dtype=torch.int32,
                                        device=card))


@pytest.mark.cuda
def test_cuda_kernel_past_2_31_residues(card):
    """5 x 429,496,730 residues (8.6 GB): offsets past 2**31 elements; the
    column X = b (b < M) everywhere, faults planted in the last columns."""
    codec = rrns_codec()
    B = 429_496_730
    assert len(channels(codec)) * B > 1 << 31
    x = torch.empty((len(channels(codec)), B), dtype=torch.int32, device=card)
    col = torch.arange(B, dtype=torch.int32, device=card)
    for c, m in enumerate(channels(codec)):
        torch.remainder(col, m, out=x[c])
    del col
    last = torch.arange(B - 10, B, device=card)
    faults = [(c, B - 10 + k) for k, c in enumerate((0, 1, 2, 3, 4) * 2)]
    for c, b in faults:
        x[c, b] = (x[c, b] + 1 + c) % channels(codec)[c]
    x[0, B - 1] = (x[0, B - 1] + 1) % channels(codec)[0]   # a second fault
    counts, verdict = ops.rrns_repair_op(codec, x, verdict=True)
    assert counts.tolist() == [9, 1, 10]
    want = [c for c, _ in faults[:-1]] + [-2]
    assert verdict[B - 10 :].tolist() == want
    assert int((verdict[: B - 10] != -1).sum()) == 0
    b = last[:-1].to(torch.int64)
    for c, m in enumerate(channels(codec)):
        eq(x[c, B - 10 : B - 1], torch.remainder(b, m).to(torch.int32))
