"""The port's kernels (``repro_torch.kernels``) against the reference's.

On the CPU each wrapper (``mrc_op``, ``modmul_op``, ``compare_op``) runs its
kernel's plain torch version — the same f32 Barrett arithmetic as the CUDA
source — and is held against the reference's Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` runs them, and against the reference's
jnp oracles.  Tests marked ``cuda`` hold each CUDA kernel against its plain
version on the card and skip on a host without one.

Tolerance: none.  Digits, products and verdicts must match exactly
(``assert_array_equal``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.core import Layout as RLayout, RnsArray as RArray
from repro.core.base import make_base as r_make_base
from repro.kernels import compare_op as r_compare_op
from repro.kernels import modmul_op as r_modmul_op
from repro.kernels import mrc_op as r_mrc_op
from repro.kernels import ref_compare as r_ref_compare
from repro.kernels import ref_modmul as r_ref_modmul
from repro.kernels import ref_mrc as r_ref_mrc
from repro.kernels import ref_to_ma as r_ref_to_ma
from repro_torch.core import Layout, RnsArray, backend
from repro_torch.core.base import make_base as t_make_base
from repro_torch.kernels import build, ops
from repro_torch.kernels import (
    compare_op,
    modmul_op,
    mrc_op,
    ref_compare,
    ref_modmul,
    ref_mrc,
    ref_to_ma,
)
from repro_torch.kernels.common import barrett_mod, recip
from repro_torch.kernels.modmul import modmul_kernel_call, modmul_plain
from repro_torch.kernels.mrc import mrc_kernel_call, mrc_plain
from repro_torch.kernels.rns_compare import compare_kernel_call, compare_plain

NS = [2, 3, 6, 17]
BATCHES = [1, 7, 128, 300]
BITS = [8, 13, 15]
BLOCK = 512  # one interpret-mode grid step for every batch above


def eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def T(a):
    return torch.from_numpy(np.array(a))


def rand_residues(base, batch, rng, dtype=np.int32):
    m = np.asarray(base.moduli, dtype=np.int64)
    return rng.integers(0, m, size=(batch, base.n)).astype(dtype)


def ma_channel(base, x):
    """Consistent m_a residues of residue rows, from the host big-int CRT."""
    from repro_torch.core.convert import rns_to_int

    return np.asarray([rns_to_int(base, r) % base.ma for r in x], np.int32)


# ------------------------------------------- plain versions vs Pallas kernels
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("batch", BATCHES)
def test_mrc_plain_matches_pallas(n, batch):
    rb, tb = r_make_base(n, bits=15), t_make_base(n, bits=15)
    x = rand_residues(rb, batch, np.random.default_rng(n * 1000 + batch))
    want = r_mrc_op(rb, jnp.asarray(x), block_b=BLOCK, interpret=True)
    got = mrc_op(tb, T(x))
    assert got.dtype == torch.int32
    eq(got, want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("batch", BATCHES)
def test_modmul_plain_matches_pallas(n, batch):
    rb, tb = r_make_base(n, bits=15), t_make_base(n, bits=15)
    rng = np.random.default_rng(n + batch)
    x, y = rand_residues(rb, batch, rng), rand_residues(rb, batch, rng)
    want = r_modmul_op(rb, jnp.asarray(x), jnp.asarray(y), block_b=BLOCK,
                       interpret=True)
    eq(modmul_op(tb, T(x), T(y)), want)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("batch", BATCHES)
def test_compare_plain_matches_pallas(n, batch):
    rb, tb = r_make_base(n, bits=15), t_make_base(n, bits=15)
    rng = np.random.default_rng(7 * n + batch)
    x1, x2 = rand_residues(rb, batch, rng), rand_residues(rb, batch, rng)
    x2[: batch // 3] = x1[: batch // 3]                 # equal operands
    a1, a2 = ma_channel(tb, x1), ma_channel(tb, x2)
    want = r_compare_op(rb, *map(jnp.asarray, (x1, a1, x2, a2)), block_b=BLOCK,
                        interpret=True)
    got = compare_op(tb, T(x1), T(a1), T(x2), T(a2))
    assert got.dtype == torch.bool and got.shape == (batch,)
    eq(got, want)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_kernels_bits_and_dtypes_match_pallas(bits, dtype):
    rb, tb = r_make_base(5, bits=bits), t_make_base(5, bits=bits)
    rng = np.random.default_rng(bits)
    x, y = rand_residues(rb, 64, rng, dtype), rand_residues(rb, 64, rng, dtype)
    got = mrc_op(tb, T(x))
    assert got.dtype == T(x).dtype                      # cast back to the input
    eq(got, r_mrc_op(rb, jnp.asarray(x), block_b=64, interpret=True))
    got = modmul_op(tb, T(x), T(y))
    assert got.dtype == T(x).dtype
    eq(got, r_modmul_op(rb, jnp.asarray(x), jnp.asarray(y), block_b=64,
                        interpret=True))
    a1, a2 = ma_channel(tb, x), ma_channel(tb, y)
    args = (x, a1.astype(dtype), y, a2.astype(dtype))
    eq(compare_op(tb, *map(T, args)),
       r_compare_op(rb, *map(jnp.asarray, args), block_b=64, interpret=True))


@pytest.mark.parametrize("bits", BITS)
def test_modmul_worst_case_products(bits):
    """(m-1)**2: the largest products, both Barrett correction branches."""
    rb, tb = r_make_base(8, bits=bits), t_make_base(8, bits=bits)
    x = np.broadcast_to(np.asarray(rb.moduli_np) - 1, (256, 8)).astype(np.int32)
    want = r_modmul_op(rb, jnp.asarray(x), jnp.asarray(x), block_b=256,
                       interpret=True)
    eq(modmul_op(tb, T(x), T(x)), want)
    eq(want, (x.astype(np.int64) ** 2) % rb.moduli_np)


# -------------------- full sweep: plain kernel versions vs the core oracles
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_kernels_full_sweep_match_oracles(bits, dtype):
    """Every (n, batch) of the sweep at this (bits, dtype): the wrappers'
    f32-Barrett plain versions against the port's torch.remainder oracles
    (themselves held against the reference in test_torch_core.py)."""
    for n in NS:
        tb = t_make_base(n, bits=bits)
        for batch in BATCHES:
            rng = np.random.default_rng(n * batch + bits)
            x, y = T(rand_residues(tb, batch, rng, dtype)), T(rand_residues(tb, batch, rng, dtype))
            eq(mrc_op(tb, x), ref_mrc(tb, x))
            eq(modmul_op(tb, x, y), ref_modmul(tb, x, y))
            a1, a2 = (T(ma_channel(tb, v.numpy())).to(x.dtype) for v in (x, y))
            eq(compare_op(tb, x, a1, y, a2), ref_compare(tb, x, a1, y, a2))
            eq(compare_op(tb, x, a1, x, a1), np.ones(batch, bool))


def test_ref_oracles_match_reference():
    rb, tb = r_make_base(6, bits=13), t_make_base(6, bits=13)
    rng = np.random.default_rng(6)
    x, y = rand_residues(rb, 40, rng), rand_residues(rb, 40, rng)
    eq(ref_mrc(tb, T(x)), r_ref_mrc(rb, jnp.asarray(x)))
    eq(ref_modmul(tb, T(x), T(y)), r_ref_modmul(rb, jnp.asarray(x), jnp.asarray(y)))
    digits = np.asarray(r_ref_mrc(rb, jnp.asarray(x)))
    eq(ref_to_ma(tb, T(digits)), r_ref_to_ma(rb, jnp.asarray(digits)))
    args = (x, ma_channel(tb, x), y, ma_channel(tb, y))
    eq(ref_compare(tb, *map(T, args)), r_ref_compare(rb, *map(jnp.asarray, args)))


def test_barrett_is_exact_at_the_edges():
    """The f32 Barrett step equals torch.remainder for the largest 15-bit
    moduli and every t within 2**16 of its bounds, (m-1)**2 included."""
    for m in (32749, 32719, 16381, 8191, 251, 3):
        hi = (m - 1) ** 2
        t = torch.cat([torch.arange(0, 1 << 16), torch.arange(max(hi - (1 << 16), 0), hi + 1),
                       torch.arange(m, hi, max(1, hi // 4096))]).to(torch.int32)
        mt = torch.tensor(m, dtype=torch.int32)
        eq(barrett_mod(t, mt, recip(mt)), torch.remainder(t, m))


# -------------------------------------------- RnsArray operands, wrappers
@pytest.mark.parametrize("layout", ["base_ma", "rrns"])
def test_modmul_op_on_arrays_reduces_redundant_rows(layout):
    rb, tb = r_make_base(6, bits=15), t_make_base(6, bits=15)
    rng = np.random.default_rng(len(layout))
    mb = 32603 if layout == "rrns" else None
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=40)]
    rl = RLayout(layout)
    ra = RArray.encode(rb, jnp.asarray(vals[:20]), layout=rl, mb=mb)
    rc = RArray.encode(rb, jnp.asarray(vals[20:]), layout=rl, mb=mb)
    want = r_modmul_op(ra, rc, interpret=True)
    a = RnsArray.from_numpy(rb.moduli, rb.ma, rb.bits, np.asarray(ra.residues),
                            layout=layout, mb=mb, device="cpu")
    c = RnsArray.from_numpy(rb.moduli, rb.ma, rb.bits, np.asarray(rc.residues),
                            layout=layout, mb=mb, device="cpu")
    got = modmul_op(a, c)
    assert isinstance(got, RnsArray) and got.layout.value == layout
    eq(got.residues, want.residues)
    # the redundant rows reduce in their own moduli: still the true residues
    prods = [x * y for x, y in zip(vals[:20], vals[20:])]
    eq(got.residues[:, tb.n], [p % tb.ma for p in prods])
    if mb:
        eq(got.residues[:, tb.n + 1], [p % mb for p in prods])
    # channel-major storage gives the same product
    got0 = modmul_op(a.with_channel_axis(0), c.with_channel_axis(0))
    assert got0.channel_axis == 0
    eq(got0.to_packed(), want.residues)
    with pytest.raises(TypeError):
        modmul_op(a, T(np.zeros((20, a.n_channels), np.int32)))


def test_array_operands_route_to_wrappers():
    tb = t_make_base(4, bits=15)
    rng = np.random.default_rng(1)
    x1, x2 = rand_residues(tb, 50, rng), rand_residues(tb, 50, rng)
    A = RnsArray.from_parts(tb, x1, ma_channel(tb, x1), device="cpu")
    B = RnsArray.from_parts(tb, x2, ma_channel(tb, x2), device="cpu")
    eq(compare_op(A, B), ref_compare(tb, A.x, A.xa, B.x, B.xa))
    eq(mrc_op(A), ref_mrc(tb, A.x))
    with pytest.raises(TypeError):
        compare_op(A, T(x2))


def test_kernels_reject_wide_bases():
    base = t_make_base(3, bits=31)
    x = torch.zeros(4, 3, dtype=torch.int64)
    xa = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        mrc_op(base, x)
    with pytest.raises(ValueError):
        modmul_op(base, x, x)
    with pytest.raises(ValueError):
        compare_op(base, x, xa, x, xa)


def test_tiles_are_contiguous_int32_and_channel_major_is_zero_copy():
    for x in (torch.zeros(300, 5, dtype=torch.int32),
              torch.zeros(300, 5, dtype=torch.int64),
              torch.zeros(2, 3, 7, dtype=torch.int32)[..., :5],
              torch.zeros(1, 5, dtype=torch.int32)):
        t, lead = ops._tiles(x, 5)
        assert t.is_contiguous() and t.dtype == torch.int32
        assert t.shape == (5, x.numel() // x.shape[-1]) and lead == x.shape[:-1]
    cm = torch.zeros(5, 300, dtype=torch.int32)
    assert ops._tiles(cm.T, 5)[0].data_ptr() == cm.data_ptr()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launches()
    tb = t_make_base(3, bits=15)
    x = T(rand_residues(tb, 9, np.random.default_rng(0)))
    xa = torch.zeros(9, dtype=torch.int32)
    mrc_op(tb, x), modmul_op(tb, x, x), compare_op(tb, x, xa, x, xa)
    assert ops.reset_launches() == {"mrc_op": 0, "modmul_op": 0, "compare_op": 0,
                                    "codec_encode_op": 0, "codec_decode_op": 0,
                                    "rrns_repair_op": 0, "mont_mul_op": 0,
                                    "mont_ladder_op": 0, "ssd_op": 0}


def test_kernel_calls_reject_host_tensors():
    """A kernel call checks its operands before the library is loaded."""
    tb = t_make_base(3, bits=15)
    x = torch.zeros(3, 8, dtype=torch.int32)
    m = tb.tensor("moduli_np", "cpu", torch.int32)
    image = ops._column_image(tb, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        mrc_kernel_call(x, image)
    with pytest.raises(ValueError, match="CUDA"):
        modmul_kernel_call(x, x, m)
    with pytest.raises(ValueError):
        compare_kernel_call(x, x[0], x, x[0], image, tb.ma)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_BUILD", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


# ------------------------------------------------- on the card (skip here)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits", [(2, 8), (17, 13), (137, 15)])
def test_cuda_kernels_match_plain(card, n, bits):
    base = t_make_base(n, bits=bits)
    rng = np.random.default_rng(n)
    x1 = T(rand_residues(base, 4099, rng)).to(card)
    x2 = T(rand_residues(base, 4099, rng)).to(card)
    inv = base.tensor("inv_tri_np", card, torch.int32)
    m = base.tensor("moduli_np", card, torch.int32)
    betas = base.tensor("betas_ma_np", card, torch.int32)
    t1, t2 = x1.T.contiguous(), x2.T.contiguous()
    image = ops._column_image(base, card)
    eq(mrc_kernel_call(t1, image), mrc_plain(t1, inv, m))
    eq(modmul_kernel_call(t1, t2, m), modmul_plain(t1, t2, m))
    with backend("torch"):
        A = RnsArray.from_parts(base, x1, device=card).normalize(Layout.BASE_MA)
        B = RnsArray.from_parts(base, x2, device=card).normalize(Layout.BASE_MA)
    a1, a2 = A.xa.contiguous(), B.xa.contiguous()
    eq(compare_kernel_call(t1, a1, t2, a2, image, base.ma),
       compare_plain(t1, a1, t2, a2, inv, m, betas, base.ma))
    torch.cuda.synchronize()
