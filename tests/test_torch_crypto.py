"""The port's crypto path (``repro_torch.core.montgomery``, the Montgomery
kernels of ``repro_torch.kernels``, ``repro_torch.serve`` and the crypto
serve CLI) against the reference's.

Every comparison feeds the same seeded inputs (numpy and Python's
``random``) to ``repro`` and to ``repro_torch``.  The reference's Pallas
Montgomery kernels run in interpret mode under ``repro.core.backend(
"pallas")``, as ``tests/test_crypto_service.py`` runs them.  On the CPU the
port's wrappers run the kernels' plain torch versions, the same Barrett
arithmetic as ``csrc/mont_ladder.cu``; tests marked ``cuda`` hold the CUDA
kernels against those plain versions on the card and skip on a host
without one.

Tolerance: none.  Residues, big-integer results and the f32 fingerprint
rows (exact sums at these widths) must be equal; every result also equals
Python's ``pow``/``divmod``.
"""
import doctest
import importlib
import json
import math
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.core import backend as r_backend
from repro.core.array import Layout as RLayout
from repro.core.array import RnsArray as RArray
from repro.core.base import RNSBase as RBase
from repro.core.montgomery import DualRep as RDual
from repro.core.montgomery import RNSMontgomery as RMont
from repro.core.montgomery import _mont_mul_jnp as r_mont_mul_jnp
from repro.core.montgomery import exp_bits_msb as r_exp_bits_msb
from repro.core.montgomery import ladder_step as r_ladder_step
from repro.core.montgomery import minv_residues as r_minv_residues
from repro.core.montgomery import mont_consts as r_mont_consts
from repro.core.montgomery import mont_mul as r_mont_mul
from repro.kernels.ops import _mont_tables_np as r_mont_tables_np
from repro.serve.crypto import CryptoContext as RContext
from repro.serve.crypto import make_crypto_fns as r_make_crypto_fns
from repro.serve.serve_step import crypto_state_abstract
from repro_torch.core import Layout, RnsArray, backend
from repro_torch.core.base import RNSBase, gen_coprime_moduli
from repro_torch.core.montgomery import (
    DualRep,
    RNSMontgomery,
    exp_bits_msb,
    ladder_step,
    ladder_steps,
    minv_residues,
    mont_consts,
    mont_mul,
)
from repro_torch.dist.grad_codec import GradCodec
from repro_torch.kernels import ops
from repro_torch.kernels.mont_ladder import (
    LAYOUT_FIELDS,
    MAX_CHANNELS,
    MAX_SMEM,
    _dot_rows,
    _layout_arg,
    block_layout,
    dot_limbs,
    mont_ladder_kernel_call,
    mont_ladder_plain,
    mont_mul_kernel_call,
    mont_mul_plain,
    pack_image,
    smem_bytes,
    smem_layout,
)
from repro_torch.launch import serve as t_serve
from repro_torch.serve.batcher import CryptoEngine
from repro_torch.serve.crypto import (
    CryptoContext,
    CryptoLane,
    CryptoRequest,
    make_crypto_fns,
)
from repro_torch.serve.serve_step import crypto_state_zeros

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ["base_ma", "rrns"]


def eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def bases(n_limbs: int):
    """Port and reference dual bases (the interleaved draw of
    ``CryptoContext``) and the spare modulus for RRNS layouts."""
    k = n_limbs
    ms = gen_coprime_moduli(2 * k + 3, 15)
    tb = (RNSBase(moduli=tuple(ms[0:2 * k:2]), ma=ms[2 * k]),
          RNSBase(moduli=tuple(ms[1:2 * k:2]), ma=ms[2 * k + 1]))
    rb = tuple(RBase(moduli=b.moduli, ma=b.ma, bits=15) for b in tb)
    return tb, rb, ms[2 * k + 2]


def moduli(B, Bp, count: int, rng):
    """``count`` odd moduli coprime to M·M', the first just below n_max."""
    n_max, MMp = min(B.M // 4, Bp.M // 2), B.M * Bp.M
    top = n_max - 1
    while top % 2 == 0 or math.gcd(top, MMp) != 1:
        top -= 1
    out = [top]
    while len(out) < count:
        N = rng.randrange(5, n_max) | 1
        if math.gcd(N, MMp) == 1:
            out.append(N)
    return out


def operands(Ns, rng):
    """Values < 2N per column, with the corners 0, 1, N-1, N and 2N-1."""
    vals = [rng.randrange(2 * N) for N in Ns]
    for i, f in enumerate((lambda N: 0, lambda N: 1, lambda N: N - 1,
                           lambda N: N, lambda N: 2 * N - 1)):
        if i < len(Ns):
            vals[i] = f(Ns[i])
    return vals


class Pair:
    """One batch of Montgomery operands in both packages: a different N per
    column, per-column constant rows, and x, y < 2N."""

    def __init__(self, n_limbs, layout, batch, seed):
        (B, Bp), (rB, rBp), spare = bases(n_limbs)
        self.B, self.Bp, self.rB, self.rBp = B, Bp, rB, rBp
        self.layout = Layout(layout)
        self.mb = spare if self.layout is Layout.RRNS else None
        rng = random.Random(seed)
        self.Ns = moduli(B, Bp, batch, rng)
        cs = [mont_consts(B, Bp, N, layout=self.layout, mb=self.mb)
              for N in self.Ns]
        self.neg = np.stack([c["neg"] for c in cs])
        self.n_hi = np.stack([c["n_hi"] for c in cs])
        self.lo_t = tuple(B.moduli) + (B.ma,) + ((self.mb,) if self.mb else ())
        # x takes the corners on the first columns, y on the last ones
        self.xs = operands(self.Ns, rng)
        self.ys = operands(self.Ns[::-1], rng)[::-1]
        self.bits = np.asarray([rng.randrange(2) for _ in self.Ns], np.int32)

    def rows(self, vals):
        lo = np.asarray([[v % t for t in self.lo_t] for v in vals], np.int32)
        hi = np.asarray([[v % m for m in self.Bp.moduli] for v in vals],
                        np.int32)
        return lo, hi

    def port(self, vals):
        lo, hi = self.rows(vals)
        return DualRep(RnsArray.from_packed(self.B, lo, mb=self.mb, device="cpu"),
                       RnsArray.from_packed(self.Bp, hi, device="cpu"))

    def ref(self, vals):
        lo, hi = self.rows(vals)
        return RDual(RArray.from_packed(self.rB, jnp.asarray(lo), mb=self.mb),
                     RArray.from_packed(self.rBp, jnp.asarray(hi)))


def same_dual(t, r):
    eq(t.lo.to_packed(), r.lo.to_packed())
    eq(t.hi.to_packed(), r.hi.to_packed())


# ------------------------------------------------------------- constants
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_limbs", [3, 6, 12])
def test_mont_consts_and_minv_match_reference(layout, n_limbs):
    (B, Bp), (rB, rBp), spare = bases(n_limbs)
    mb = spare if layout == "rrns" else None
    rng = random.Random(n_limbs)
    for N in moduli(B, Bp, 3, rng):
        got = mont_consts(B, Bp, N, layout=Layout(layout), mb=mb)
        want = r_mont_consts(rB, rBp, N, layout=RLayout(layout), mb=mb)
        assert sorted(got) == sorted(want)
        for k in want:
            eq(got[k], want[k])
    hi_t = tuple(Bp.moduli)
    eq(minv_residues(B, hi_t), r_minv_residues(rB, hi_t))


def test_mont_consts_refusals_match_reference():
    (B, Bp), (rB, rBp), _ = bases(3)
    for N, what in ((B.M, "M > 4N"), (B.moduli[0] * 3, "coprime")):
        with pytest.raises(ValueError, match=what):
            r_mont_consts(rB, rBp, N)
        with pytest.raises(ValueError, match=what):
            mont_consts(B, Bp, N)


@pytest.mark.parametrize("e,nbits", [(0, 1), (1, 1), (0b1011, 8),
                                     (65537, 17), ((1 << 40) - 3, 64)])
def test_exp_bits_msb_matches_reference(e, nbits):
    eq(exp_bits_msb(e, nbits), r_exp_bits_msb(e, nbits))


def test_exp_bits_msb_refuses_wide_exponents():
    with pytest.raises(ValueError, match="bits"):
        exp_bits_msb(1 << 8, 8)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_limbs", [2, 6, 17])
def test_mont_tables_match_reference(layout, n_limbs):
    """The port's tables are the reference's in the CUDA kernel's
    orientation: the triangles and both beta tables transposed, the moduli
    and M^{-1} rows flat."""
    (B, Bp), (rB, rBp), spare = bases(n_limbs)
    lo_t = tuple(B.moduli) + (B.ma,) + ((spare,) if layout == "rrns" else ())
    got = ops._mont_tables_np(B, Bp, lo_t)
    want = r_mont_tables_np(rB, rBp, lo_t)
    for i in (0, 2, 3, 5):          # inv_lo, bl2h, inv_hi, bh2l
        eq(got[i], np.asarray(want[i]).T)
    for i in (1, 4, 6):             # m_lo, m_hi, minv
        eq(got[i], np.asarray(want[i])[:, 0])
    dev = ops._mont_tables(B, Bp, lo_t, torch.device("cpu"))
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in dev)
    for t, w in zip(dev, got):
        eq(t, w)


def _image_sections(img, n, nch_lo, n_hi):
    """The kernels' image cut into its sections (smem_layout)."""
    L = smem_layout(n, nch_lo, n_hi)
    i32 = lambda off, cnt: img[off : off + 4 * cnt].view(np.int32)
    u32 = lambda off, cnt: img[off : off + 4 * cnt].view(np.uint32)
    u16 = lambda off, cnt: img[off : off + 2 * cnt].view(np.uint16)
    planes = lambda off, nt, st: img[off : off + 2 * nt * st].reshape(2, nt, st)
    return L, {
        "m_lo": i32(L["m_lo"], L["nt2"]), "mu_lo": u32(L["mu_lo"], L["nt2"]),
        "m_hi": i32(L["m_hi"], L["nt1"]), "mu_hi": u32(L["mu_hi"], L["nt1"]),
        "minv": i32(L["minv"], L["nt1"]),
        "tri_lo": u16(L["tri_lo"], n * (n - 1) // 2),
        "tri_hi": u16(L["tri_hi"], n_hi * (n_hi - 1) // 2),
        "b1": planes(L["b1"], L["nt1"], L["s1"]),
        "b2": planes(L["b2"], L["nt2"], L["s2"]),
    }


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("n_limbs", [2, 6, 17])
def test_mont_image_matches_reference(layout, n_limbs):
    """The kernels' shared-memory image, as ``ops._mont_image`` builds it,
    holds the reference's tables: the moduli with floor(2**32 / m) and
    M^{-1}, the triangles' upper halves (``inv_tri_np``, row by row) as
    16-bit words, and ``betas_for`` one row per target split into byte
    planes — zero wherever the MMA tiles pad, modulus 1 on padded
    targets."""
    (B, Bp), (rB, rBp), spare = bases(n_limbs)
    lo_t = tuple(B.moduli) + (B.ma,) + ((spare,) if layout == "rrns" else ())
    hi_t = tuple(Bp.moduli)
    n, nch_lo, n_hi = B.n, len(lo_t), Bp.n
    img = ops._mont_image(B, Bp, lo_t, torch.device("cpu"))
    assert img.dtype == torch.uint8 and img.is_contiguous()
    L, sec = _image_sections(img.numpy(), n, nch_lo, n_hi)
    assert img.numel() == L["image"] and L["image"] % 16 == 0
    for side, targets, nt in (("lo", lo_t, L["nt2"]), ("hi", hi_t, L["nt1"])):
        m = np.asarray(targets + (1,) * (nt - len(targets)), np.int64)
        eq(sec["m_" + side], m)
        eq(sec["mu_" + side], ((1 << 32) // m) & 0xFFFFFFFF)
    eq(sec["minv"][:n_hi], r_minv_residues(rB, hi_t))
    eq(sec["minv"][n_hi:], 0)
    for key, rb in (("tri_lo", rB), ("tri_hi", rBp)):
        tri = np.asarray(rb.inv_tri_np)
        eq(sec[key], tri[np.triu_indices(tri.shape[0], k=1)])
    for key, rb, targets, k in (("b1", rB, hi_t, n), ("b2", rBp, lo_t, n_hi)):
        betas = np.asarray(rb.betas_for(targets), np.int64)      # (T, k)
        lo, hi = sec[key]
        eq(lo[: len(targets), :k], betas & 0xFF)
        eq(hi[: len(targets), :k], betas >> 8)
        for plane in (lo, hi):
            assert not plane[len(targets):].any() and not plane[:, k:].any()
    # 16-bit halves of a 15-bit table lose nothing
    assert max(sec["tri_lo"].max(initial=0), sec["tri_hi"].max(initial=0)) < 1 << 15


@pytest.mark.parametrize("n,nch_lo,n_hi", [(1, 2, 1), (138, 139, 138),
                                           (138, 140, 138), (160, 160, 160)])
def test_mont_smem_fits_a_block(n, nch_lo, n_hi):
    """Every shape the kernels take fits a 16-column block's shared memory
    (the launch refuses one that does not); the sections follow each other
    in order (an empty triangle at n = 1 takes no bytes), 16-byte aligned
    for the block's cp.async copy."""
    L = smem_layout(n, nch_lo, n_hi)
    assert smem_bytes(n, nch_lo, n_hi, 16) <= MAX_SMEM
    order = ["m_lo", "mu_lo", "m_hi", "mu_hi", "minv", "tri_lo", "tri_hi",
             "b1", "b2", "image"]
    assert all(L[a] <= L[b] for a, b in zip(order, order[1:]))
    assert L["m_lo"] < L["b1"] < L["b2"] < L["image"]
    assert all(L[k] % 16 == 0 for k in order)


@pytest.mark.parametrize("cols", [8, 16])
@pytest.mark.parametrize("n,nch_lo,n_hi", [(1, 2, 1), (138, 139, 138),
                                           (160, 160, 160)])
def test_mont_block_layout_is_what_the_kernels_take(n, nch_lo, n_hi, cols):
    """The launch's layout argument carries ``block_layout`` field by field
    in the order of the kernels' ``Layout`` struct (read from the source:
    the kernels compute no offset of their own), and a block's scratch —
    digit planes, residue tile, output tile — follows the image without
    overlap."""
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
           "kernels" / "csrc" / "mont_ladder.cu").read_text()
    body = src[src.index("struct Layout {"):]
    body = body[: body.index("};")]
    decls = [ln.split("//")[0] for ln in body.splitlines()[1:]]
    fields = [f.strip() for d in decls if d.strip()
              for f in d.strip().removeprefix("int ").rstrip(";").split(",")]
    assert tuple(fields) == LAYOUT_FIELDS
    assert f"kLayoutFields = {len(LAYOUT_FIELDS)};" in src
    L = block_layout(n, nch_lo, n_hi, cols)
    assert list(_layout_arg(n, nch_lo, n_hi, cols)) == [L[f] for f in
                                                       LAYOUT_FIELDS]
    assert L["cols"] == cols and L["image"] == smem_layout(n, nch_lo,
                                                           n_hi)["image"]
    assert L["dig"] == L["image"] and L["res"] == L["dig"] + 2 * 16 * L["sd"]
    assert L["io"] == L["res"] + 4 * cols * L["rs"]
    assert L["smem"] == L["io"] + 4 * L["io_rows"] * (cols + 1)
    assert L["smem"] == smem_bytes(n, nch_lo, n_hi, cols) <= MAX_SMEM
    assert L["rs"] >= max(L["nt1"], L["nt2"]) and L["sd"] >= max(L["k1"],
                                                                 L["k2"])


def _planes(img, n, nch_lo, n_hi, key, targets, k):
    L, sec = _image_sections(img, n, nch_lo, n_hi)
    lo, hi = sec[key]
    return (torch.from_numpy(lo[:targets, :k].copy()),
            torch.from_numpy(hi[:targets, :k].copy()))


@pytest.mark.parametrize("digits", ["worst", "random"])
@pytest.mark.parametrize("n_limbs", [3, 138])
def test_dot_limbs_equals_dot_rows(n_limbs, digits):
    """The kernels' tensor-core dot — u8 limb products summed exactly, one
    exact reduction — equals the term-by-term Barrett dot ``_dot_rows`` bit
    for bit, for both extensions (B -> B' and B' -> B with the redundant
    channels), with every digit at m_j - 1 and with random digits."""
    (B, Bp), _, spare = bases(n_limbs)
    lo_t = tuple(B.moduli) + (B.ma, spare)
    tables = ops._mont_tables_np(B, Bp, lo_t)
    img = pack_image(*tables)
    n, nch_lo, n_hi = B.n, len(lo_t), Bp.n
    rng = np.random.default_rng(n_limbs)
    for key, src, betas, targets in (("b1", B.moduli, tables[2], Bp.moduli),
                                     ("b2", Bp.moduli, tables[5], lo_t)):
        m_src = np.asarray(src, np.int64)[:, None]
        d = (np.broadcast_to(m_src - 1, (len(src), 64)) if digits == "worst"
             else rng.integers(0, 1 << 40, (len(src), 64)) % m_src)
        d = torch.from_numpy(np.ascontiguousarray(d, np.int32))
        m = torch.tensor(targets, dtype=torch.int32)
        lo, hi = _planes(img, n, nch_lo, n_hi, key, len(targets), len(src))
        eq(dot_limbs(d, lo, hi, m), _dot_rows(d, torch.from_numpy(betas), m))


def test_dot_limb_sums_fit_s32_at_max_channels():
    """The bound the kernels' s32 accumulators rest on: at MAX_CHANNELS
    digits and table entries of 15 bits, every limb sum is below 2**24."""
    d = torch.full((MAX_CHANNELS, 1), (1 << 15) - 1, dtype=torch.int64)
    b = torch.full((1, MAX_CHANNELS), (1 << 15) - 1, dtype=torch.int64)
    limbs = lambda x: (x & 0xFF, x >> 8)
    sums = [bl @ dl for bl in limbs(b) for dl in limbs(d)]
    assert max(int(s.max()) for s in sums) < 1 << 24
    m = torch.tensor([32749], dtype=torch.int32)
    got = dot_limbs(d.to(torch.int32), *(p.to(torch.uint8) for p in limbs(b)),
                    m)
    assert int(got) == (MAX_CHANNELS * ((1 << 15) - 1) ** 2) % 32749


def _mrc_lazy(w, inv, m):
    """The kernels' MRC triangle in numpy, step for step: each channel kept
    as z = 0x4B400000 m - r (mod 2**32) with r in (-m, m); a step's
    quotient the integer nearest t_f * (1/m)_f (what the FFMA with
    1.5 * 2**23 rounds to: the f32 product of two f32 values is exact in
    f64); only the broadcast digit made canonical."""
    w = np.asarray(w, np.int64)
    m64 = np.asarray(m, np.int64)[:, None]
    rc = (np.float32(1) / np.asarray(m, np.float32)).astype(np.float64)[:, None]
    c = (0x4B400000 * m64) & 0xFFFFFFFF
    z = (c - w) & 0xFFFFFFFF
    signed = lambda u: np.where(u >= 1 << 31, u - (1 << 32), u)
    for j in range(w.shape[0] - 1):
        a = signed((c[j] - z[j]) & 0xFFFFFFFF)
        a = a + np.where(a < 0, m64[j], 0)
        i = slice(j + 1, None)
        d = signed((c[i] - z[i] - a) & 0xFFFFFFFF)
        t = d * np.asarray(inv, np.int64)[j, i][:, None]
        assert (np.abs(t) < 1 << 31).all()
        q = np.rint(t.astype(np.float32).astype(np.float64) * rc[i])
        assert (np.abs(q) < 1 << 22).all()
        r = t - q.astype(np.int64) * m64[i]
        assert (np.abs(r) < m64[i]).all() and ((r - t) % m64[i] == 0).all()
        z[i] = (c[i] - r) & 0xFFFFFFFF
    r = signed((c - z) & 0xFFFFFFFF)
    return r + np.where(r < 0, m64, 0)


@pytest.mark.parametrize("values", ["worst", "zero", "random"])
@pytest.mark.parametrize("n_limbs", [3, 138])
def test_kernels_lazy_mrc_equals_mrc_rows(n_limbs, values):
    """The kernels' MRC arithmetic (one FFMA-rounded quotient a step, no
    correction until the digit is broadcast) gives the digits of the plain
    triangle ``mrc_rows`` bit for bit, on both bases of the RSA-2048 pair
    and a small one, with residues at m - 1, at 0 and random; every step's
    remainder stays in (-m, m)."""
    from repro_torch.kernels.common import mrc_rows

    (B, Bp), _, _ = bases(n_limbs)
    rng = np.random.default_rng(7)
    for base in (B, Bp):
        m = np.asarray(base.moduli, np.int64)[:, None]
        w = {"worst": np.broadcast_to(m - 1, (base.n, 32)),
             "zero": np.zeros((base.n, 32), np.int64),
             "random": rng.integers(0, 1 << 40, (base.n, 32)) % m}[values]
        inv = np.asarray(base.inv_tri_np, np.int64)
        want = mrc_rows(torch.from_numpy(np.ascontiguousarray(w, np.int32)),
                        torch.from_numpy(inv.astype(np.int32)),
                        torch.tensor(base.moduli, dtype=torch.int32))
        eq(_mrc_lazy(w, inv, base.moduli), want)


# ------------------------------------- the product and the ladder bit
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mont_mul_matches_reference(layout):
    """Both port routes on the CPU — the plain product of core/montgomery.py
    and the kernel wrapper's plain twin — equal the reference's jnp product
    and its Pallas kernel bit for bit on every channel, with a different N
    in each of 64 columns (one just below n_max) and the operand corners
    0, 1, N-1, N, 2N-1; and the big-int oracle x·y·M^{-1} mod N."""
    p = Pair(6, layout, 64, seed=1)
    x, y, rx, ry = p.port(p.xs), p.port(p.ys), p.ref(p.xs), p.ref(p.ys)
    plain = mont_mul(x, y, p.neg, p.n_hi)
    twin = ops.mont_mul_op(x, y, torch.from_numpy(p.neg),
                           torch.from_numpy(p.n_hi))
    neg, nhi = jnp.asarray(p.neg), jnp.asarray(p.n_hi)
    same_dual(plain, r_mont_mul_jnp(rx, ry, neg, nhi))
    with r_backend("pallas"):
        same_dual(twin, r_mont_mul(rx, ry, neg, nhi))
    same_dual(twin, plain)
    lo = plain.lo.to_packed().numpy()
    from repro_torch.core.convert import rns_to_int
    for i, (a, b, N) in enumerate(zip(p.xs, p.ys, p.Ns)):
        R = rns_to_int(p.B, lo[i][: p.B.n])
        assert R < 2 * N and R % N == a * b * pow(p.B.M, -1, N) % N
        assert [int(v) for v in lo[i]] == [R % t for t in p.lo_t]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ladder_step_matches_reference(layout):
    """One ladder bit on 64 columns with mixed bits: the port's plain route
    and the kernel's plain twin equal the reference's Pallas kernel."""
    p = Pair(6, layout, 64, seed=2)
    r0, r1, q0, q1 = p.port(p.xs), p.port(p.ys), p.ref(p.xs), p.ref(p.ys)
    bit = torch.from_numpy(p.bits)
    plain = ladder_step(r0, r1, bit, p.neg, p.n_hi)
    twin = ops.mont_ladder_op(r0, r1, bit, torch.from_numpy(p.neg),
                              torch.from_numpy(p.n_hi))
    with r_backend("pallas"):
        want = r_ladder_step(q0, q1, jnp.asarray(p.bits), jnp.asarray(p.neg),
                             jnp.asarray(p.n_hi))
    for a, b, w in zip(plain, twin, want):
        same_dual(a, w)
        same_dual(b, w)


@pytest.mark.parametrize("bits", ["zeros", "ones"])
def test_ladder_step_uniform_bits_match_reference(bits):
    p = Pair(6, "base_ma", 16, seed=3)
    b = np.full(16, 0 if bits == "zeros" else 1, np.int32)
    r0, r1 = p.port(p.xs), p.port(p.ys)
    twin = ops.mont_ladder_op(r0, r1, torch.from_numpy(b), p.neg, p.n_hi)
    want = r_ladder_step(p.ref(p.xs), p.ref(p.ys), jnp.asarray(b),
                         jnp.asarray(p.neg), jnp.asarray(p.n_hi))
    for a, w in zip(twin, want):
        same_dual(a, w)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ladder_steps_match_reference_bit_by_bit(layout):
    """Five ladder bits in a row on 32 columns with random bits: the lane's
    ``ladder_steps`` (plain route) and ``ops.mont_ladder_steps_op`` (the
    kernels' wrapper, plain on the CPU, its operands kept in the kernels'
    tiles between bits) equal five ``ladder_step`` calls of the reference;
    no launch is counted on the CPU."""
    p = Pair(6, layout, 32, seed=9)
    bits = np.random.default_rng(9).integers(0, 2, (32, 5)).astype(np.int32)
    r0, r1 = p.port(p.xs), p.port(p.ys)
    before = ops.mont_ladder_op.launches
    plain = ladder_steps(r0, r1, torch.from_numpy(bits), p.neg, p.n_hi)
    twin = ops.mont_ladder_steps_op(r0, r1, torch.from_numpy(bits),
                                    torch.from_numpy(p.neg),
                                    torch.from_numpy(p.n_hi))
    q0, q1 = p.ref(p.xs), p.ref(p.ys)
    for i in range(bits.shape[1]):
        q0, q1 = r_ladder_step(q0, q1, jnp.asarray(bits[:, i]),
                               jnp.asarray(p.neg), jnp.asarray(p.n_hi))
    for a, b, w in zip(plain, twin, (q0, q1)):
        same_dual(a, w)
        same_dual(b, w)
    assert ops.mont_ladder_op.launches == before


@pytest.mark.parametrize("n_limbs", [2, 3, 17])
def test_kernel_plain_twins_match_core_product(n_limbs):
    """At the widths the chip sweep starts from, the tile-level twins equal
    the plain core product (itself held against the reference above)."""
    p = Pair(n_limbs, "rrns", 7, seed=n_limbs)
    x, y = p.port(p.xs), p.port(p.ys)
    tables = ops._mont_tables(p.B, p.Bp, p.lo_t, torch.device("cpu"))
    tiles = [torch.from_numpy(t).T.contiguous()
             for t in (*p.rows(p.xs), *p.rows(p.ys))]
    neg_t = torch.from_numpy(p.neg).T.contiguous()
    nhi_t = torch.from_numpy(p.n_hi).T.contiguous()
    lo, hi = mont_mul_plain(*tiles, neg_t, nhi_t, *tables)
    want = mont_mul(x, y, p.neg, p.n_hi)
    eq(lo.T, want.lo.to_packed())
    eq(hi.T, want.hi.to_packed())
    bit = torch.from_numpy(p.bits)
    outs = mont_ladder_plain(*tiles, bit, neg_t, nhi_t, *tables)
    for got, w in zip(outs, [t for d in ladder_step(x, y, bit, p.neg, p.n_hi)
                             for t in (d.lo, d.hi)]):
        eq(got.T, w.to_packed())


def test_mont_ops_broadcast_one_modulus_over_the_batch():
    """One (n,) constant row broadcasts over a batch of operands, as the
    reference's ``lead`` broadcasting does; the count of kernel launches
    stays 0 on the CPU."""
    p = Pair(4, "base_ma", 5, seed=5)
    N = p.Ns[1]
    c = mont_consts(p.B, p.Bp, N)
    vals = [v % (2 * N) for v in p.xs]
    x = p.port(vals)
    before = (ops.mont_mul_op.launches, ops.mont_ladder_op.launches)
    got = ops.mont_mul_op(x, x, c["neg"], c["n_hi"])
    same_dual(got, r_mont_mul_jnp(p.ref(vals), p.ref(vals),
                                  jnp.asarray(c["neg"]), jnp.asarray(c["n_hi"])))
    a, b = ops.mont_ladder_op(x, x, 1, c["neg"], c["n_hi"])
    ra, rb = r_ladder_step(p.ref(vals), p.ref(vals), jnp.int32(1),
                           jnp.asarray(c["neg"]), jnp.asarray(c["n_hi"]))
    same_dual(a, ra)
    same_dual(b, rb)
    assert (ops.mont_mul_op.launches, ops.mont_ladder_op.launches) == before


def test_kernel_wrappers_refuse_host_tensors_and_bad_tables():
    """No fallback: the kernel wrappers take CUDA tensors only, and check
    the table image's size against the operand shapes first."""
    p = Pair(3, "base_ma", 4, seed=6)
    image = ops._mont_image(p.B, p.Bp, p.lo_t, torch.device("cpu"))
    tiles = [torch.from_numpy(t).T.contiguous()
             for t in (*p.rows(p.xs), *p.rows(p.ys))]
    neg_t = torch.from_numpy(p.neg).T.contiguous()
    nhi_t = torch.from_numpy(p.n_hi).T.contiguous()
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul_kernel_call(*tiles, neg_t, nhi_t, image)
    bit = torch.from_numpy(p.bits)
    with pytest.raises(ValueError, match="CUDA"):
        mont_ladder_kernel_call(*tiles, bit, neg_t, nhi_t, image)
    with pytest.raises(ValueError, match="table image"):
        mont_mul_kernel_call(*tiles, neg_t, nhi_t, image[:-16])
    with backend("cuda"), pytest.raises(ValueError, match="CUDA tensor"):
        mont_mul(p.port(p.xs), p.port(p.ys), p.neg, p.n_hi)
    # wider than the kernels' widest template instance: refused up front
    n = MAX_CHANNELS + 1
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 160 channels"):
        mont_mul_kernel_call(z(n + 1, 2), z(n, 2), z(n + 1, 2), z(n, 2),
                             z(n, 2), z(n, 2), torch.zeros(16, dtype=torch.uint8))


def test_dualrep_hi_must_be_base_layout():
    (B, Bp), _, _ = bases(3)
    lo = RnsArray.from_packed(B, np.zeros(B.n + 1, np.int32), device="cpu")
    with pytest.raises(ValueError, match="Layout.BASE"):
        DualRep(lo, lo)


# -------------------------------------------------------- RNSMontgomery
@pytest.mark.parametrize("n_limbs", [6, 12])
def test_rns_montgomery_modexp_modmul_match_pow_and_reference(n_limbs):
    (B, Bp), (rB, rBp), _ = bases(n_limbs)
    rng = random.Random(n_limbs)
    N = moduli(B, Bp, 2, rng)[1]
    mont = RNSMontgomery(B, Bp, N, device="cpu")
    cases = [(rng.randrange(1, N), rng.randrange(1 << 16)),
             (rng.randrange(1, N), 0), (rng.randrange(1, N), 1),
             (N - 1, (1 << 16) - 1)]
    for a, e in cases:
        assert mont.modexp(a, e) == pow(a, e, N), (a, e)
    a, b = rng.randrange(N), rng.randrange(N)
    assert mont.modmul(a, b) == a * b % N
    assert mont.modmul(N - 1, N - 1) == 1
    with r_backend("jnp"):
        ref = RMont(rB, rBp, N)
        assert ref.modexp(*cases[0]) == mont.modexp(*cases[0])
        assert ref.modmul(a, b) == mont.modmul(a, b)


@pytest.mark.parametrize("n_limbs", [6, 12])
def test_rns_montgomery_mul_and_approx_match_reference(n_limbs):
    """``mul`` (exact) and ``mul(approx=True)`` (Kawamura extension) give
    the reference's residues; the exact product also leaves the domain to
    x·y mod N."""
    (B, Bp), (rB, rBp), _ = bases(n_limbs)
    rng = random.Random(100 + n_limbs)
    N = moduli(B, Bp, 2, rng)[1]
    mont, ref = RNSMontgomery(B, Bp, N, device="cpu"), RMont(rB, rBp, N)
    R = B.M % N
    for _ in range(3):
        a, b = rng.randrange(N), rng.randrange(N)
        x, y = mont.to_dual(a * R % N), mont.to_dual(b * R % N)
        rx, ry = ref.to_dual(a * R % N), ref.to_dual(b * R % N)
        with r_backend("jnp"):
            same_dual(mont.mul(x, y), ref.mul(rx, ry))
            got, want = mont.mul(x, y, approx=True), ref.mul(rx, ry, approx=True)
        eq(got.xB, want.xB)
        eq(got.xBp, want.xBp)
        out = mont.mul(mont.mul(x, y), mont.to_dual(1))
        assert mont.from_dual(out) % N == a * b % N


def test_rns_montgomery_base_layout_refuses_canonicalization():
    (B, Bp), _, _ = bases(3)
    mont = RNSMontgomery(B, Bp, 1000003, layout=Layout.BASE, device="cpu")
    with pytest.raises(ValueError, match="m_a channel"):
        mont.modmul(3, 5)


# ---------------------------------------------------- the lane's functions
def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_crypto_fns_match_reference_tick_by_tick():
    """admit, step, final, modmul, divmod and fp on the same requests give
    the reference's rows bit for bit, after every call."""
    S, chunk = 4, 4
    ctx, rctx = (CryptoContext(n_limbs=4, exp_bits=16),
                 RContext(n_limbs=4, exp_bits=16))
    fns, rfns = make_crypto_fns(ctx, chunk), r_make_crypto_fns(rctx, chunk)
    state = crypto_state_zeros(ctx, S, "cpu")
    rstate = {k: jnp.zeros(v.shape, v.dtype)
              for k, v in crypto_state_abstract(rctx, S).items()}
    rng = random.Random(9)
    reqs = []
    for slot in (0, 2, 3):
        N = moduli(ctx.baseB, ctx.baseBp, 2, rng)[1]
        reqs.append((slot, N, rng.randrange(N), rng.randrange(1 << 16)))

    def rows(c, a, e):
        return [ctx.encode_lo(a), ctx.encode_hi(a), c["m2_lo"], c["m2_hi"],
                c["one_lo"], c["one_hi"], c["neg"], c["n_lo"], c["n_hi"],
                np.asarray(r_exp_bits_msb(e, 16))]

    def same_state():
        want = _state_np(rstate)
        for k, v in state.items():
            eq(v, want[k])

    for slot, N, a, e in reqs:
        args = rows(ctx.consts_for(N), a, e)
        state = fns["admit"](state, slot, *[torch.from_numpy(np.asarray(v))[None]
                                            for v in args])
        rstate = rfns["admit"](rstate, jnp.int32(slot),
                               *[jnp.asarray(v)[None] for v in args])
        same_state()
        eq(fns["fp"](state, slot), rfns["fp"](rstate, jnp.int32(slot)))
    active = np.asarray([1, 0, 1, 1], np.int32)
    for tick in range(16 // chunk):
        cursors = np.asarray([chunk * tick, 0, chunk * tick, chunk * tick],
                             np.int32)
        state = fns["step"](state, torch.from_numpy(cursors),
                            torch.from_numpy(active))
        rstate = rfns["step"](rstate, jnp.asarray(cursors),
                              jnp.asarray(active))
        same_state()
    for slot, N, a, e in reqs:
        got = fns["final"](state, slot)
        eq(got, rfns["final"](rstate, jnp.int32(slot)))
        assert ctx.decode_lo(got[0]) == pow(a, e, N)
        eq(fns["fp"](state, slot), rfns["fp"](rstate, jnp.int32(slot)))
    # the one-shots
    N = moduli(ctx.baseB, ctx.baseBp, 2, rng)[1]
    c, a, b = ctx.consts_for(N), rng.randrange(N), rng.randrange(N)
    args = [ctx.encode_lo(a), ctx.encode_hi(a), ctx.encode_lo(b),
            ctx.encode_hi(b), c["m2_lo"], c["m2_hi"], c["neg"], c["n_hi"],
            c["n_lo"]]
    got = fns["modmul"](*[torch.from_numpy(np.asarray(v))[None] for v in args])
    eq(got, rfns["modmul"](*[jnp.asarray(v)[None] for v in args]))
    assert ctx.decode_lo(got[0]) == a * b % N
    M = ctx.baseB.M
    x, d = rng.randrange(M), rng.randrange(1, M)
    xp, dp = (ctx.encode_lo(v)[: ctx.n + 1][None] for v in (x, d))
    q, r = fns["divmod"](torch.from_numpy(xp), torch.from_numpy(dp))
    rq, rr = rfns["divmod"](jnp.asarray(xp), jnp.asarray(dp))
    eq(q, rq)
    eq(r, rr)
    assert (ctx.decode_lo(q[0]), ctx.decode_lo(r[0])) == divmod(x, d)


def test_fingerprint_reduces_in_a_fixed_order():
    """fp gives the same bits for the same rows, and equals the exact sums
    where they stay below 2**24."""
    ctx = CryptoContext(n_limbs=4, exp_bits=16)
    fns = make_crypto_fns(ctx, 4)
    g = torch.Generator().manual_seed(0)
    state = {k: torch.randint(0, 1 << 15, tuple(v.shape), generator=g,
                              dtype=torch.int32)
             for k, v in crypto_state_zeros(ctx, 3, "cpu").items()}
    a, b = fns["fp"](state, 1), fns["fp"](state, torch.tensor(1))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = []
    for k in ("bits", "neg", "n_lo", "n_hi"):
        row = state[k][1].to(torch.int64)
        w = torch.arange(1, row.shape[0] + 1)
        want += [int(row.sum()), int((row * w).sum())]
    assert [int(v) for v in a] == want


def test_rsa2048_fingerprint_sum_exceeds_f32_and_codec_clip():
    """The reference's fingerprint comment claims exact f32 sums "for
    15-bit residues over <= 2**8 channels".  At the RSA-2048 lane width
    (n_limbs = 138, nch_lo = 139) the index-weighted n_lo sum is bounded by
    (2**15 - 1)·139·140/2 = 318,822,910: above 2**24, so it is rounded,
    and above the fingerprint codec's clip, so it can clip.  The port keeps
    the reference's fingerprint for parity (ROADMAP, queue 3)."""
    ctx = CryptoContext(n_limbs=138, exp_bits=2048)
    assert (ctx.n, ctx.nch_lo, ctx.n_hi) == (138, 139, 138)
    bound = max(m - 1 for m in ctx.lo_targets) * ctx.nch_lo * (ctx.nch_lo + 1) // 2
    assert bound <= (2 ** 15 - 1) * 139 * 140 // 2 == 318_822_910
    assert bound > 1 << 24
    clip = GradCodec.make(world=1, correct=True).clip
    assert 267_069_708 < clip < 267_069_709
    assert bound > clip
    # an n_lo row of N = n_max - 1 shows it: the weighted sum is past 2**24
    N = ctx.n_max - 1
    while N % 2 == 0 or math.gcd(N, ctx.baseB.M * ctx.baseBp.M) != 1:
        N -= 1
    row = ctx.consts_for(N)["n_lo"].astype(np.int64)
    assert int((row * np.arange(1, ctx.nch_lo + 1)).sum()) > 1 << 24


# ---------------------------------------------------------- the engine
def _engine(**kw):
    kw.setdefault("crypto_slots", 4)
    kw.setdefault("crypto_chunk", 4)
    kw.setdefault("crypto_ctx", CryptoContext(n_limbs=4, exp_bits=16))
    return CryptoEngine(device="cpu", **kw)


def _oracle(r):
    return (divmod(r.a, r.b) if r.op == "divmod"
            else pow(r.a % r.n, r.b, r.n) if r.op == "modexp"
            else r.a * r.b % r.n)


def test_engine_mixed_load_matches_oracle_and_verifies():
    eng = _engine(rns_verify=True)
    reqs = t_serve.synth_crypto_requests(
        14, np.random.default_rng(3), eng.crypto_ctx, arrival_rate=0.5,
        rid0=100)
    for r in reqs:
        eng.submit(r)
    done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    for r in done:
        assert r.result == _oracle(r), (r.rid, r.op)
        assert eng.verify_log[r.rid] is True
        assert r.t_done is not None and r.t_admit is not None
    # 5 modexps through 4 lane slots: at least one slot is reused
    used = [r.slot_index for r in done if r.op == "modexp"]
    assert len(used) == 5 and set(used) <= {0, 1, 2, 3}
    drained = eng.drain_completed()
    assert sorted(r.rid for r in drained) == [r.rid for r in reqs]
    assert eng.verify_log == {} and len(eng.wire) == 0
    assert not eng.busy and eng.crypto.completed == []


def test_engine_wire_corrupt_detect_and_repair():
    eng = _engine(rns_verify=True)
    N = 1000003
    assert math.gcd(N, eng.crypto_ctx.baseB.M * eng.crypto_ctx.baseBp.M) == 1
    eng.submit(CryptoRequest(rid=1, op="modexp", a=777, b=4321, n=N))
    eng.try_admit(0.0)   # slot bound, fingerprint published
    key = ("crypto", 1)
    assert eng.wire_ok(key)
    eng.corrupt_wire(key, channel=0, delta=5)
    assert not eng.wire_ok(key)               # detected by redundancy
    rep = eng.repair_wire(key)
    assert rep["repaired"] == 1 and rep["unrecoverable"] == 0
    assert eng.wire_ok(key)                   # located and corrected
    done = eng.run_to_completion()
    assert done[0].result == pow(777, 4321, N)
    assert eng.verify_log[1] is True          # retirement re-verified


def test_engine_two_slots_all_at_once_match_oracle():
    """Six requests arriving together on two slots: modexps wait for a
    free slot while the one-shots run, in FIFO order."""
    ctx = CryptoContext(n_limbs=4, exp_bits=16)
    reqs = t_serve.synth_crypto_requests(
        6, np.random.default_rng(4), ctx, arrival_rate=0.0, rid0=0)
    eng = _engine(crypto_ctx=ctx, crypto_slots=2)
    for r in reqs:
        eng.submit(r)
    got = {r.rid: r.result for r in eng.run_to_completion()}
    assert got == {r.rid: _oracle(r) for r in reqs}


def test_engine_verify_needs_rns_verify():
    eng = _engine()
    with pytest.raises(RuntimeError, match="rns_verify"):
        eng.wire_ok(("crypto", 0))


def test_duplicate_rid_rejected_under_verify():
    eng = _engine(rns_verify=True)
    eng.submit(CryptoRequest(rid=8, op="modexp", a=2, b=3, n=1000003))
    with pytest.raises(ValueError, match="rid 8"):
        eng.submit(CryptoRequest(rid=8, op="modmul", a=2, b=3, n=1000003))


def test_context_and_lane_validation():
    """The reference's ``test_context_and_lane_validation``, on the port."""
    ctx = CryptoContext(n_limbs=4, exp_bits=16)
    with pytest.raises(ValueError, match="unknown crypto op"):
        ctx.validate(CryptoRequest(rid=0, op="sqrt", a=1, b=1))
    with pytest.raises(ValueError, match="needs a modulus"):
        ctx.validate(CryptoRequest(rid=0, op="modexp", a=1, b=1))
    with pytest.raises(ValueError, match="must lie in"):
        ctx.validate(CryptoRequest(rid=0, op="modexp", a=1, b=1,
                                   n=ctx.n_max + 1))
    with pytest.raises(ValueError, match="coprime"):
        ctx.validate(CryptoRequest(rid=0, op="modexp", a=1, b=1,
                                   n=ctx.baseB.moduli[0] * 3))
    with pytest.raises(ValueError, match="exp_bits"):
        ctx.validate(CryptoRequest(rid=0, op="modexp", a=1,
                                   b=1 << ctx.exp_bits, n=1000003))
    with pytest.raises(ValueError, match="dynamic range"):
        ctx.validate(CryptoRequest(rid=0, op="divmod", a=ctx.baseB.M, b=1))
    with pytest.raises(ValueError, match="divide exp_bits"):
        CryptoLane(1, exp_bits=16, chunk=5)
    with pytest.raises(ValueError, match="BASE_MA or RRNS"):
        CryptoContext(n_limbs=3, layout=Layout.BASE)


def test_context_matches_reference():
    for kw in (dict(n_limbs=4, exp_bits=16),
               dict(n_limbs=5, exp_bits=8, layout="rrns")):
        t = CryptoContext(**{**kw, "layout": Layout(kw.get("layout", "base_ma"))})
        r = RContext(**{**kw, "layout": RLayout(kw.get("layout", "base_ma"))})
        assert t.baseB.moduli == r.baseB.moduli and t.baseBp.moduli == r.baseBp.moduli
        assert (t.baseB.ma, t.baseBp.ma, t.mb) == (r.baseB.ma, r.baseBp.ma, r.mb)
        assert t.lo_targets == r.lo_targets and t.n_max == r.n_max
        assert (t.nch_lo, t.n, t.n_hi) == (r.nch_lo, r.n, r.n_hi)


def test_crypto_family_gating():
    """The reference's ``test_crypto_family_gating``, on the port: the
    engine serves the crypto family only, and a context without slots is a
    configuration error."""
    from repro_torch.serve.crypto import CryptoRequest as Req

    eng = _engine()
    llm = Req(rid=0, op="modexp", a=2, b=3, n=1000003, family="llm")
    with pytest.raises(ValueError, match="serve slice"):
        eng.submit(llm)
    bad = Req(rid=1, op="modexp", a=2, b=3, n=1000003, family="audio")
    with pytest.raises(ValueError, match="unknown request family"):
        eng.submit(bad)
    with pytest.raises(ValueError, match="crypto_slots"):
        CryptoEngine(crypto_slots=0, crypto_ctx=CryptoContext(n_limbs=3),
                     device="cpu")
    with pytest.raises(ValueError, match="crypto_slots"):
        CryptoEngine(crypto_slots=0, device="cpu")


# ------------------------------------------------------------ the CLI
def test_synth_crypto_requests_match_reference():
    from repro.launch.serve import synth_crypto_requests as r_synth

    ctx, rctx = (CryptoContext(n_limbs=5, exp_bits=32),
                 RContext(n_limbs=5, exp_bits=32))
    got = t_serve.synth_crypto_requests(4, np.random.default_rng(7), ctx,
                                        arrival_rate=0.25, rid0=3)
    want = r_synth(4, np.random.default_rng(7), rctx, arrival_rate=0.25,
                   rid0=3)
    key = lambda r: (r.rid, r.op, r.a, r.b, r.n, r.arrival)
    assert [key(r) for r in got] == [key(r) for r in want]


def test_serve_cli_crypto_subprocess():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--families", "crypto", "--crypto-slots", "2", "--crypto-requests",
         "6", "--crypto-limbs", "3", "--crypto-exp-bits", "8",
         "--crypto-chunk", "4", "--rns-verify", "--inject-wire-corrupt"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)
    assert report["crypto"]["requests"] == 6
    assert report["crypto"]["oracle_failed"] == 0
    assert report["crypto"]["oracle_ok"] == 6
    rns = report["rns"]
    assert rns["slots_failed"] == 0 and rns["slots_verified"] == 6
    assert rns["injected_detected"] and rns["injected_reverified"]
    assert rns["injected_repair"] == {"repaired": 1, "unrecoverable": 0}


@pytest.mark.parametrize("argv,what", [
    (["--mode", "loadgen", "--crypto-slots", "1"], "drop --trace"),
    (["--families", "crypto,audio", "--crypto-slots", "1"], "subset"),
    (["--crypto-requests", "2"], "crypto-slots"),
    (["--families", "crypto", "--crypto-slots", "2"], "crypto-requests"),
])
def test_serve_cli_refusals(argv, what, capsys):
    with pytest.raises(SystemExit):
        t_serve.main(["--device", "cpu", *argv])
    assert what in capsys.readouterr().err


def test_rns_modmul_example_on_cpu():
    from repro_torch import rns_modmul

    out = rns_modmul.main("cpu", verbose=False)
    assert out["got"] == out["want"] and out["needs_sub"] is False


# ------------------------------------------------------------- doctests
@pytest.mark.parametrize("name", ["repro_torch.core.montgomery",
                                  "repro_torch.serve.crypto",
                                  "repro_torch.serve.serve_step",
                                  "repro_torch.serve.batcher"])
def test_port_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0 and result.failed == 0


# ------------------------------------------------- on the card (skip here)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 9, 16, 17, 300, 1024, 2113])
@pytest.mark.parametrize("n_limbs,layout", [(3, "base_ma"), (17, "rrns"),
                                            (64, "base_ma")])
def test_cuda_mont_kernels_match_plain(card, n_limbs, layout, batch):
    """Batches on and off the block widths (8 and 16 columns; 16 from 2,112
    columns on, where 16-column blocks still cover 132 SMs)."""
    p = Pair(n_limbs, layout, batch, seed=n_limbs)
    tables = ops._mont_tables(p.B, p.Bp, p.lo_t, card)
    image = ops._mont_image(p.B, p.Bp, p.lo_t, card)
    tiles = [t.T.contiguous().to(card)
             for t in map(torch.from_numpy, (*p.rows(p.xs), *p.rows(p.ys)))]
    neg_t = torch.from_numpy(p.neg).T.contiguous().to(card)
    nhi_t = torch.from_numpy(p.n_hi).T.contiguous().to(card)
    for got, want in zip(mont_mul_kernel_call(*tiles, neg_t, nhi_t, image),
                         mont_mul_plain(*tiles, neg_t, nhi_t, *tables)):
        eq(got, want.cpu())
    bit = torch.from_numpy(p.bits).to(card)
    for got, want in zip(
            mont_ladder_kernel_call(*tiles, bit, neg_t, nhi_t, image),
            mont_ladder_plain(*tiles, bit, neg_t, nhi_t, *tables)):
        eq(got, want.cpu())
    torch.cuda.synchronize()
