"""Parity of ``repro_torch.core`` with the JAX reference ``repro.core``.

Inputs are made from seeds with numpy and handed to both packages; the port
runs on CPU tensors (its plain torch route), the reference on its jnp path.
Tolerance: none.  Every integer output — tables, residues, digits, verdicts,
m_a channels, quotients, remainders — must match exactly
(``assert_array_equal``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.configs.paper_rns import make_paper_bases as r_paper_bases
from repro.core.arith import add as r_add, mul as r_mul, neg as r_neg, sub as r_sub
from repro.core.base import (
    gen_coprime_moduli as r_gen,
    is_prime as r_is_prime,
    make_base as r_make_base,
)
from repro.core.compare import (
    _compare_ge_impl as r_compare_impl,
    approx_crt_ge as r_approx,
    classic_compare_ge as r_classic,
    compare_packed_ge as r_packed_ge,
    rns_compare_ge as r_compare_ge,
)
from repro.core.convert import (
    mrs_dot_mod as r_dot_mod,
    rns_to_int as r_rns_to_int,
    rns_to_tensor as r_rns_to_tensor,
    tensor_to_rns as r_tensor_to_rns,
    to_ma as r_to_ma,
)
from repro.core.division import (
    divmod_rns as r_divmod,
    halve as r_halve,
    parity as r_parity,
    scale_pow2 as r_scale,
)
from repro.core.extend import (
    extend_kawamura as r_kawamura,
    extend_mrc as r_extend_mrc,
    extend_shenoy as r_shenoy,
)
from repro.core.mrc import mrc as r_mrc, mrs_ge as r_mrs_ge
from repro.core.mrc_tree import mrc_tree as r_mrc_tree
from repro.core.signed import (
    abs_ge_threshold as r_abs_ge,
    encode_signed as r_encode_signed,
    is_negative as r_is_negative,
)
from repro_torch.configs.paper_rns import make_paper_bases as t_paper_bases
from repro_torch.core import arith as t_arith
from repro_torch.core.base import (
    gen_coprime_moduli as t_gen,
    is_prime as t_is_prime,
    make_base as t_make_base,
)
from repro_torch.core.compare import (
    _compare_ge_impl as t_compare_impl,
    approx_crt_ge as t_approx,
    classic_compare_ge as t_classic,
    compare_packed_ge as t_packed_ge,
    rns_compare_ge as t_compare_ge,
)
from repro_torch.core.convert import (
    int_to_rns as t_int_to_rns,
    mrs_dot_mod as t_dot_mod,
    rns_to_int as t_rns_to_int,
    rns_to_tensor as t_rns_to_tensor,
    tensor_to_rns as t_tensor_to_rns,
    to_ma as t_to_ma,
)
from repro_torch.core.division import (
    divmod_rns as t_divmod,
    halve as t_halve,
    parity as t_parity,
    scale_pow2 as t_scale,
)
from repro_torch.core.extend import (
    extend_kawamura as t_kawamura,
    extend_mrc as t_extend_mrc,
    extend_shenoy as t_shenoy,
)
from repro_torch.core.mrc import (
    mrc as t_mrc,
    mrc_unrolled as t_mrc_unrolled,
    mrs_ge as t_mrs_ge,
    mrs_to_int as t_mrs_to_int,
)
from repro_torch.core.mrc_tree import mrc_tree as t_mrc_tree
from repro_torch.core.signed import (
    abs_ge_threshold as t_abs_ge,
    encode_signed as t_encode_signed,
    is_negative as t_is_negative,
)


def eq(got, want):
    """Exact equality of a torch result and a jax/numpy reference."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def T(a):
    """numpy -> CPU torch tensor (the port's input)."""
    return torch.from_numpy(np.array(a))


def J(a):
    """numpy -> jax array (the reference's input)."""
    return jnp.asarray(a)


def bases(n, bits):
    return r_make_base(n, bits=bits), t_make_base(n, bits=bits)


def residues(base, batch, rng, dtype=None):
    m = np.asarray(base.moduli, dtype=np.int64)
    return rng.integers(0, m, size=(batch, base.n)).astype(dtype or base.dtype)


def values(base, batch, rng):
    """Random Python ints in [0, M), edges included."""
    vals = [int.from_bytes(rng.bytes(base.M.bit_length() // 8 + 8), "little")
            % base.M for _ in range(batch)]
    return [0, 1, base.M - 1, base.M // 2, (base.M + 1) // 2] + vals


def packed_of(base, vals):
    """(batch, n+1) residues + consistent m_a channel of Python ints."""
    return np.asarray([list(base.residues_of(v)) + [v % base.ma] for v in vals],
                      dtype=base.dtype)


# ------------------------------------------------------------------ base
@pytest.mark.parametrize("bits", [8, 13, 15, 31])
@pytest.mark.parametrize("n", [2, 3, 6, 17, 137])
def test_base_tables(n, bits):
    try:
        rb = r_make_base(n, bits=bits)
    except ValueError:
        with pytest.raises(ValueError):
            t_make_base(n, bits=bits)
        return
    tb = t_make_base(n, bits=bits)
    assert (tb.moduli, tb.ma, tb.bits, tb.M) == (rb.moduli, rb.ma, rb.bits, rb.M)
    assert tb.dtype == rb.dtype
    assert tb.tdtype == (torch.int32 if bits <= 15 else torch.int64)
    targets = (rb.ma, 101, 32749)
    for name in ("moduli_np", "inv_tri_np", "betas_ma_np", "Mi_inv_np",
                 "inv2_np", "half_M_residues"):
        want = getattr(rb, name)
        got = getattr(tb, name)
        assert got.dtype == want.dtype, name
        eq(got, want)
        eq(tb.tensor(name, "cpu"), want)               # the device cache
        assert tb.tensor(name, "cpu") is tb.tensor(name, "cpu")
    for name in ("betas_for", "Mi_mod", "M_mod"):
        eq(getattr(tb, name)(targets), getattr(rb, name)(targets))
        eq(tb.tensor((name, targets), "cpu", torch.int64),
           getattr(rb, name)(targets))
    for name in ("M_mod_ma", "inv2_ma", "half_M_ma"):
        assert getattr(tb, name) == getattr(rb, name), name
    for v in (0, 1, -1, rb.M - 1, -(rb.M // 3), 10**40 + 7):
        eq(tb.residues_of(v), rb.residues_of(v))
        assert tb.ma_residue_of(v) == rb.ma_residue_of(v)


def test_prime_generation():
    assert [t_is_prime(x) for x in range(-3, 3000)] == [
        r_is_prime(x) for x in range(-3, 3000)]
    for x in (2**31 - 1, 2**61 - 1, 3215031751, 2**61 + 1):
        assert t_is_prime(x) == r_is_prime(x)
    assert t_gen(40, 13, skip=3) == r_gen(40, 13, skip=3)
    with pytest.raises(ValueError):
        t_gen(60, 8)


def test_paper_bases():
    (rb, rbp), (tb, tbp) = r_paper_bases(), t_paper_bases()
    assert tb.n == 137 and tb.bits == 15
    assert (tb.moduli, tb.ma) == (rb.moduli, rb.ma)
    assert (tbp.moduli, tbp.ma) == (rbp.moduli, rbp.ma)


# ----------------------------------------------------------- arith & MRC
@pytest.mark.parametrize("bits", [8, 15, 31])
@pytest.mark.parametrize("n", [1, 2, 6, 17])
def test_arith_and_mrc_variants(n, bits):
    rb, tb = bases(n, bits)
    rng = np.random.default_rng(100 * n + bits)
    dtypes = (np.int32, np.int64) if bits <= 15 else (np.int64,)
    for dtype in dtypes:
        x, y = residues(rb, 37, rng, dtype), residues(rb, 37, rng, dtype)
        want = np.asarray(r_mrc(rb, J(x)))
        got = t_mrc(tb, T(x))
        assert got.dtype == T(x).dtype
        eq(got, want)
        eq(t_mrc_unrolled(tb, T(x)), want)
        eq(t_mrc_tree(tb, T(x)), np.asarray(r_mrc_tree(rb, J(x))))
        eq(t_mrc_tree(tb, T(x)), want)
        assert t_mrs_to_int(tb, got[3]) == t_rns_to_int(tb, x[3])
        for r_fn, t_fn in ((r_add, t_arith.add), (r_sub, t_arith.sub),
                           (r_mul, t_arith.mul)):
            eq(t_fn(tb, T(x), T(y)), r_fn(rb, J(x), J(y)))
        eq(t_arith.neg(tb, T(x)), r_neg(rb, J(x)))
        eq(t_arith.mul_const(tb, T(x), rb.inv2_np),
           np.mod(x.astype(np.int64) * rb.inv2_np, rb.moduli_np))


def test_mrs_ge_matches():
    rb, tb = bases(6, 15)
    rng = np.random.default_rng(5)
    d1 = residues(rb, 200, rng)
    d2 = d1.copy()
    # equal rows, rows differing only in the least and the most significant
    # digit, and random rows
    d2[50:100, 0] = (d2[50:100, 0] + 1) % rb.moduli_np[0]
    d2[100:150, -1] = (d2[100:150, -1] + 7) % rb.moduli_np[-1]
    d2[150:] = residues(rb, 50, rng)
    for a, b in ((d1, d2), (d2, d1)):
        eq(t_mrs_ge(T(a), T(b)), r_mrs_ge(J(a), J(b)))


# ------------------------------------------------------------ conversions
@pytest.mark.parametrize("n,bits", [(4, 8), (8, 15), (17, 13), (5, 31)])
def test_to_ma_and_dot_mod(n, bits):
    rb, tb = bases(n, bits)
    rng = np.random.default_rng(n + bits)
    digits = np.asarray(r_mrc(rb, J(residues(rb, 37, rng))))
    eq(t_to_ma(tb, T(digits)), r_to_ma(rb, J(digits)))
    targets = (rb.ma, 101, 32749)
    eq(t_dot_mod(tb, T(digits), targets), r_dot_mod(rb, J(digits), targets))


def test_tensor_codecs_and_big_ints():
    rb, tb = bases(3, 15)
    rng = np.random.default_rng(3)
    half = rb.M // 2
    v = rng.integers(-half + 1, half, size=(4, 33), dtype=np.int64)
    v[0, :4] = [0, -1, half - 1, -half + 1]
    res = np.asarray(r_tensor_to_rns(rb, J(v)))
    got = t_tensor_to_rns(tb, T(v))
    assert got.dtype == torch.int32
    eq(got, res)
    eq(t_rns_to_tensor(tb, T(res)), r_rns_to_tensor(rb, J(res)))
    digits = np.asarray(r_mrc(rb, J(res)))
    eq(t_rns_to_tensor(tb, T(digits), from_digits=True),
       r_rns_to_tensor(rb, J(digits), from_digits=True))
    with pytest.raises(ValueError):
        t_rns_to_tensor(t_make_base(17), torch.zeros(2, 17, dtype=torch.int32))
    rb17, tb17 = bases(17, 15)
    for x in values(rb17, 20, rng) + [-5, -(rb17.M // 2)]:
        eq(t_int_to_rns(tb17, x), rb17.residues_of(x))
        r = rb17.residues_of(x)
        assert t_rns_to_int(tb17, r) == r_rns_to_int(rb17, r) == x % rb17.M
        assert t_rns_to_int(tb17, T(r)) == x % rb17.M


# --------------------------------------------------------------- extension
@pytest.mark.parametrize("n,bits", [(3, 15), (6, 13), (4, 31)])
def test_extensions(n, bits):
    rb, tb = bases(n, bits)
    rng = np.random.default_rng(7 * n)
    vals = values(rb, 12, rng)
    # values near the top of the range exercise Kawamura's error band
    vals += [rb.M - 1 - k * (rb.M // 1000) for k in range(20)]
    x = np.asarray([rb.residues_of(v) for v in vals], dtype=rb.dtype)
    targets = (rb.ma, 101, 127)
    eq(t_extend_mrc(tb, T(x), targets), r_extend_mrc(rb, J(x), targets))
    mr = 65521                  # a 16-bit prime: coprime to every base here
    xr = np.asarray([v % mr for v in vals], dtype=np.int64)
    eq(t_shenoy(tb, T(x), T(xr), mr, targets), r_shenoy(rb, J(x), J(xr), mr, targets))
    eq(t_kawamura(tb, T(x), targets), r_kawamura(rb, J(x), targets))
    eq(t_kawamura(tb, T(x), targets, alpha=0.25, q=6),
       r_kawamura(rb, J(x), targets, alpha=0.25, q=6))
    with pytest.raises(ValueError):
        t_shenoy(tb, T(x), T(xr), n, targets)


# -------------------------------------------------------------- comparison
@pytest.mark.parametrize("n,bits", [(2, 8), (5, 15), (17, 15), (6, 13)])
def test_comparisons(n, bits):
    rb, tb = bases(n, bits)
    rng = np.random.default_rng(11 * n + bits)
    v1 = values(rb, 32, rng)
    v2 = values(rb, 32, rng)
    v2[:8] = v1[:8]                                   # equal pairs
    v2[8:12] = [v + 1 if v + 1 < rb.M else v for v in v1[8:12]]  # off by one
    p1, p2 = packed_of(rb, v1), packed_of(rb, v2)
    x1, a1, x2, a2 = p1[:, :-1], p1[:, -1], p2[:, :-1], p2[:, -1]
    truth = np.asarray([a >= b for a, b in zip(v1, v2)])
    want = np.asarray(r_compare_ge(rb, J(x1), J(a1), J(x2), J(a2)))
    eq(want, truth)
    eq(t_compare_ge(tb, T(x1), T(a1), T(x2), T(a2)), want)
    eq(t_compare_impl(tb, T(x1), T(a1), T(x2), T(a2), unroll=True), want)
    eq(t_packed_ge(tb, T(p1), T(p2)), r_packed_ge(rb, J(p1), J(p2)))
    eq(t_classic(tb, T(x1), T(x2)), r_classic(rb, J(x1), J(x2)))
    eq(t_classic(tb, T(x1), T(x2), unroll=True), truth)
    eq(t_approx(tb, T(x1), T(x2)), r_approx(rb, J(x1), J(x2)))
    eq(t_approx(tb, T(x1), T(x2), frac_bits=12),
       r_approx(rb, J(x1), J(x2), frac_bits=12))


def test_compare_impl_paper_width():
    """One n = 137 (2048-bit) case of Algorithm 1 at batch 64."""
    rb, tb = r_paper_bases()[0], t_paper_bases()[0]
    rng = np.random.default_rng(137)
    v1, v2 = values(rb, 59, rng), values(rb, 59, rng)
    v2[:3] = v1[:3]
    p1, p2 = packed_of(rb, v1), packed_of(rb, v2)
    args = (p1[:, :-1], p1[:, -1], p2[:, :-1], p2[:, -1])
    want = np.asarray(r_compare_impl(rb, *map(J, args)))
    eq(want, [a >= b for a, b in zip(v1, v2)])
    eq(t_compare_impl(tb, *map(T, args)), want)


# ----------------------------------------------------------------- signed
def test_signed():
    rb, tb = bases(4, 15)
    rng = np.random.default_rng(9)
    half = rb.M // 2
    v = rng.integers(-half + 1, half, size=(3, 40), dtype=np.int64)
    v[0, :6] = [0, -1, 1, half - 1, -half + 1, -2]
    packed = np.asarray(r_encode_signed(rb, J(v)))
    eq(t_encode_signed(tb, T(v)), packed)
    eq(t_is_negative(tb, T(packed)), r_is_negative(rb, J(packed)))
    eq(t_is_negative(tb, T(packed)), v < 0)
    for thr in (1, 1000, int(v[0, 3])):
        eq(t_abs_ge(tb, T(packed), thr), r_abs_ge(rb, J(packed), thr))
        eq(t_abs_ge(tb, T(packed), thr), np.abs(v) >= thr)


# --------------------------------------------------------------- division
def test_halve_scale_parity():
    rb, tb = bases(4, 8)
    rng = np.random.default_rng(4)
    vals = values(rb, 32, rng)
    p = packed_of(rb, vals)
    eq(t_parity(tb, T(p[:, :-1])), r_parity(rb, J(p[:, :-1])))
    eq(t_parity(tb, T(p[:, :-1])), [v % 2 for v in vals])
    eq(t_halve(tb, T(p)), r_halve(rb, J(p)))
    eq(t_scale(tb, T(p), 5), r_scale(rb, J(p), 5))
    eq(t_scale(tb, T(p), 5), packed_of(rb, [v >> 5 for v in vals]))


def test_divmod():
    rb, tb = bases(4, 8)
    rng = np.random.default_rng(44)
    xs = values(rb, 32, rng)
    ds = [int(d) for d in rng.integers(1, 1 << 20, size=len(xs))]
    ds[:3] = [1, rb.M - 1, 3]
    xp, dp = packed_of(rb, xs), packed_of(rb, ds)
    rq, rr = r_divmod(rb, J(xp), J(dp))
    tq, tr = t_divmod(tb, T(xp), T(dp))
    eq(tq, rq)
    eq(tr, rr)
    eq(tq, packed_of(rb, [x // d for x, d in zip(xs, ds)]))
    eq(tr, packed_of(rb, [x % d for x, d in zip(xs, ds)]))
    rq, rr = r_divmod(rb, J(xp), J(dp), iters=12)
    tq, tr = t_divmod(tb, T(xp), T(dp), iters=12)
    eq(tq, rq)
    eq(tr, rr)
