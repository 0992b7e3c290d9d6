"""The column kernels (``csrc/mrc.cu``, ``csrc/rns_compare.cu``) as they
map a column — a warp a column in the reverse slot order for n > 16, a
thread a column for n <= 16 — with the lazy MRC step and the dot into
m_a (reduced across the warp), emulated in numpy from the table image the
kernels stage; the wrappers' strided views of channels-last and packed
rows; and, on the card, the kernels themselves.

``emulate_mrc`` and ``emulate_compare`` repeat ``csrc/mrc_warp.cuh``'s and
``csrc/rns_compare.cu``'s arithmetic step by step (vectorised over lanes
and columns): every triangle entry is read from the image bytes at the
offset the kernel computes, spare lanes included, and every step checks
the ranges the source's exactness argument needs.  They are held against
the plain versions (``mrc_rows``, ``compare_plain``) and against the
reference's Pallas kernels in interpret mode.

Tolerance: none — digits and verdicts must be equal.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.core.base import make_base as r_make_base
from repro.kernels import compare_op as r_compare_op
from repro.kernels import mrc_op as r_mrc_op
from repro_torch.core import Layout, RnsArray, backend
from repro_torch.core.base import make_base as t_make_base
from repro_torch.core.convert import rns_to_int
from repro_torch.kernels import build, ops
from repro_torch.kernels import mrc as mrc_mod
from repro_torch.kernels.common import mrc_rows
from repro_torch.kernels.mrc import (column_image, column_layout,
                                     column_mapping, launch_geometry,
                                     mrc_kernel_call, mrc_plain)
from repro_torch.kernels.rns_compare import compare_kernel_call, compare_plain

M32 = 0xFFFFFFFF
MAGIC = 0x4B400000
# (n, bits) of the emulation sweep: 137 and 138 moduli do not exist below
# 2**8
CASES = [(n, bits) for n in (2, 3, 6, 8, 17, 137, 138) for bits in (8, 13, 15)
         if not (n > 100 and bits == 8)]


def eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def slots(n: int) -> int:
    """Register slots a lane of the warp mapping's instance for n
    (columns.cuh)."""
    return 5 if n <= 160 else 14


def signed(u):
    return np.where(u >= 1 << 31, u - (1 << 32), u)


def barrett(t, m):
    """common.cuh::barrett_mod in numpy: f32 quotient, one correction each
    way; asserts its precondition 0 <= t < m * 2**15."""
    t = np.asarray(t, np.int64)
    assert (t >= 0).all() and (t < np.int64(m) << 15).all()
    r32 = np.float32(1) / np.float32(m)
    q = np.floor(t.astype(np.float32) * r32).astype(np.int64)
    r = t - q * m
    r = r + np.where(r < 0, m, 0)
    return r - np.where(r >= m, m, 0)


def lazy_step(c, z, a, inv, m, rc):
    """mrc_warp.cuh's step on stored forms z = c - r (mod 2**32), r in
    (-m, m), against the canonical digit a and the table word inv: checks
    the ranges the exactness argument needs and returns the new z."""
    d = signed((c - z - a) & M32)
    assert (np.abs(d) < 1 << 16).all()
    t = d * inv
    assert (np.abs(t) < 1 << 31).all()
    # what the FFMA with 1.5 * 2**23 rounds to: the f32 product of two f32
    # values is exact in f64
    q = np.rint(t.astype(np.float32).astype(np.float64) * rc)
    assert (np.abs(q) < 1 << 22).all()
    u = ((MAGIC + q.astype(np.int64)) * m - t) & M32
    r = signed((c - u) & M32)
    assert (np.abs(r) < m).all() and ((r - t) % m == 0).all()
    return u


def canonical(c, z, m):
    v = signed((c - z) & M32)
    return v + np.where(v < 0, m, 0)


class Image:
    """The tables as a kernel reads them from its image: moduli and betas
    by channel, and the triangle's words at byte offsets that must fall
    inside the staged image."""

    def __init__(self, image: np.ndarray, n: int):
        self.img, self.n, self.L = image, n, column_layout(n)
        words = lambda off: image[off : off + 4 * n].view(np.int32).astype(np.int64)
        self.moduli, self.betas = words(0), words(self.L["betas"])

    def tri(self, idx):
        off = self.L["tri"] + 2 * np.asarray(idx)
        assert (off >= 0).all() and (off + 2 <= self.img.size).all()
        return self.img[off].astype(np.int64) | self.img[off + 1].astype(np.int64) << 8


class Thread(Image):
    """The thread mapping (n <= 16): mrc_thread<N> on (n, B) columns."""

    def __init__(self, image: np.ndarray, n: int):
        super().__init__(image, n)
        self.m = self.moduli[:, None]
        self.rc = (np.float32(1) / self.m.astype(np.float32)).astype(np.float64)

    def load(self, rows):
        return np.asarray(rows, np.int64).T.copy()

    def unload(self, w):
        return w.T

    def mrc(self, w):
        n, m, rc = self.n, self.m, self.rc
        c = (MAGIC * m) & M32
        z = (c - w) & M32
        out = np.zeros_like(w)
        for j in range(n):
            a = canonical(c[j], z[j], m[j])
            out[j] = a
            for i in range(j + 1, n):
                idx = j * (2 * n - j - 1) // 2 + i - j - 1
                assert 0 <= idx < n * (n - 1) // 2
                z[i] = lazy_step(c[i], z[i], a, self.tri(idx), m[i], rc[i])
        return out

    def dot(self, w, ma):
        """The thread's n terms a_i beta_i mod m_a, summed, reduced once."""
        s = barrett(w * self.betas[:, None], ma).sum(axis=0)
        assert (s < 16 * ma).all()
        return barrett(s, ma)


class Lanes(Image):
    """The warp mapping (n > 16): the (S, 32) slot grid r = 32 k + l, the
    moduli, reciprocals and betas each lane loads, mrc_warp<32, S> lane by
    lane and the dot reduced across the warp."""

    def __init__(self, image: np.ndarray, n: int):
        super().__init__(image, n)
        self.G, self.S = 32, slots(n)
        k, l = np.meshgrid(np.arange(self.S), np.arange(self.G), indexing="ij")
        self.r = self.G * k + l                        # (S, G)
        self.live = self.r < n
        self.ch = np.where(self.live, n - 1 - self.r, 0)
        self.m = np.where(self.live, self.moduli[self.ch], 1)[..., None]
        self.rc = (np.float32(1) / self.m.astype(np.float32)).astype(np.float64)
        self.beta = np.where(self.live, self.betas[self.ch], 0)[..., None]

    def load(self, rows):
        """(B, n) rows -> (S, G, B) in the MRC mapping, 0 on spare lanes."""
        rows = np.asarray(rows, np.int64)
        return np.where(self.live[..., None], rows[:, self.ch].transpose(1, 2, 0), 0)

    def unload(self, w):
        out = np.zeros((w.shape[-1], self.n), np.int64)
        out[:, self.ch[self.live]] = w[self.live].T
        return out

    def mrc(self, w):
        """mrc_warp<32, S> on (S, G, B) residues -> canonical digits; every
        lane's table read, the spare lanes' included, inside the image."""
        G, S, n, m = self.G, self.S, self.n, self.m
        c = (MAGIC * m) & M32
        z = (c - w) & M32
        lane = np.arange(G)
        row = n - 2 - lane                          # entry offsets, per lane
        for s in range(S - 1, -1, -1):
            top, bottom = min(G * s + G - 1, n - 1), max(G * s, 1)
            for r in range(top, bottom - 1, -1):
                a = canonical(c[s], z[s], m[s])[r - G * s]  # the broadcast
                assert (a >= 0).all() and (a < self.m[r // G, r % G]).all()
                open_ = lane < r - G * s
                for k in range(s + 1):
                    inv = self.tri(row - G * k)[:, None]
                    keep = (k < s) | open_
                    if keep.any():
                        zk = z[k].copy()
                        zk[keep] = lazy_step(c[k][keep], z[k][keep], a,
                                             inv[keep], m[k][keep],
                                             self.rc[k][keep])
                        z[k] = zk
                row = row + (r - 1)
        return canonical(c, z, m)

    def dot(self, w, ma):
        """A term a_i beta_i mod m_a a slot, the lane's sum over its slots,
        the butterfly across the warp, one reduction at lane 0."""
        terms = barrett(w * self.beta, ma)          # (S, G, B)
        s = terms.sum(axis=0)                       # (G, B), < S m_a
        off = self.G // 2
        while off:
            s = s + s[np.arange(self.G) ^ off]
            off //= 2
        assert (s < 448 * ma).all() and (s < 1 << 24).all()
        return barrett(s[0], ma)


def mapping(image, n):
    return (Thread if column_mapping(n) == 1 else Lanes)(image, n)


def emulate_mrc(image, n, x):
    k = mapping(image, n)
    return k.unload(k.mrc(k.load(x)))


def emulate_compare(image, n, ma, x1, xa1, x2, xa2):
    k = mapping(image, n)
    w = k.load(x1) - k.load(x2)
    w = w + np.where(w < 0, k.m, 0)
    delta = k.dot(k.mrc(w), ma)
    dp = np.asarray(xa1, np.int64) - np.asarray(xa2, np.int64)
    dp = dp + np.where(dp < 0, ma, 0)
    return (delta == dp).astype(np.int32)


def residue_rows(base, values):
    return np.asarray([[v % m for m in base.moduli] for v in values], np.int64)


def operand_pairs(base, batch: int, seed: int):
    """N1, N2 pairs: N1 = N2, N1 = N2 + 1, N1 = N2 - 1 and random ones in
    turn; 0 and M - 1 both ways and against themselves; and the worst-case
    residue row (m - 1 on every channel, M - 1) against 0."""
    M, rnd = base.M, random.Random(seed)
    N2 = [rnd.randrange(1, M - 1) for _ in range(batch)]
    N1 = [(v, v + 1, v - 1, rnd.randrange(M))[i % 4] for i, v in enumerate(N2)]
    N1[:5], N2[:5] = [0, M - 1, 0, M - 1, M - 1], [M - 1, 0, 0, M - 1, 0]
    x1, x2 = residue_rows(base, N1), residue_rows(base, N2)
    assert (x1[4] == np.asarray(base.moduli) - 1).all()
    return x1, x2, N1, N2


@pytest.mark.parametrize("n,bits", CASES)
def test_emulated_mrc_matches_plain_and_pallas(n, bits):
    """The MRC kernel's mapping on worst-case (m - 1), zero and random
    residues gives the plain triangle's digits and the reference Pallas
    kernel's, bit for bit; every triangle read stays in the staged image."""
    tb, rb = t_make_base(n, bits=bits), r_make_base(n, bits=bits)
    image = column_image(tb.moduli_np, tb.betas_ma_np, tb.inv_tri_np)
    m = np.asarray(tb.moduli, np.int64)
    rng = np.random.default_rng(n * 100 + bits)
    x = np.concatenate([np.broadcast_to(m - 1, (4, n)), np.zeros((3, n), np.int64),
                        rng.integers(0, 1 << 40, (57, n)) % m])
    got = emulate_mrc(image, n, x)
    xt = torch.from_numpy(x.T.astype(np.int32))
    eq(got.T, mrc_rows(xt, tb.tensor("inv_tri_np", "cpu", torch.int32),
                       tb.tensor("moduli_np", "cpu", torch.int32)))
    eq(got, r_mrc_op(rb, jnp.asarray(x.astype(np.int32)), block_b=64,
                     interpret=True))


@pytest.mark.parametrize("n,bits", CASES)
def test_emulated_compare_matches_plain_and_pallas(n, bits):
    """The compare kernel's mapping (subtract, triangle, the dot, reduced
    across the warp for n > 16) on the operand pairs N1 = N2, N2 +- 1,
    0 and M - 1 and random ones gives compare_plain's verdicts, the
    reference Pallas kernel's and the big-integer truth."""
    tb, rb = t_make_base(n, bits=bits), r_make_base(n, bits=bits)
    image = column_image(tb.moduli_np, tb.betas_ma_np, tb.inv_tri_np)
    x1, x2, N1, N2 = operand_pairs(tb, 64, n + 7 * bits)
    xa1 = np.asarray([v % tb.ma for v in N1], np.int64)
    xa2 = np.asarray([v % tb.ma for v in N2], np.int64)
    got = emulate_compare(image, n, tb.ma, x1, xa1, x2, xa2)
    eq(got, [int(a >= b) for a, b in zip(N1, N2)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))
    eq(got, compare_plain(t(x1.T), t(xa1), t(x2.T), t(xa2),
                          tb.tensor("inv_tri_np", "cpu", torch.int32),
                          tb.tensor("moduli_np", "cpu", torch.int32),
                          tb.tensor("betas_ma_np", "cpu", torch.int32), tb.ma))
    want = r_compare_op(rb, *(jnp.asarray(a.astype(np.int32))
                              for a in (x1, xa1, x2, xa2)),
                        block_b=64, interpret=True)
    eq(got, want)


@pytest.mark.parametrize("n", [1, 2, 8, 9, 16, 17, 137, 138, 160, 161, 448])
def test_column_image_holds_the_base_tables(n):
    """The image's moduli, betas and triangle words at column_layout's
    offsets; the triangle starts 16-aligned and at least 64 bytes on (the
    spare lanes' reads), the image is a whole number of 16-byte copies."""
    bits = 15 if n > 100 else 13
    tb = t_make_base(n, bits=bits)
    L = column_layout(n)
    img = column_image(tb.moduli_np, tb.betas_ma_np, tb.inv_tri_np)
    assert img.dtype == np.uint8 and img.size == L["image"]
    assert L["tri"] % 16 == 0 and L["tri"] >= 64 and L["image"] % 16 == 0
    assert L["tri"] >= L["betas"] + 4 * n
    eq(img[: 4 * n].view(np.int32), tb.moduli_np)
    eq(img[L["betas"] : L["betas"] + 4 * n].view(np.int32), tb.betas_ma_np)
    tri = img[L["tri"] : L["tri"] + n * (n - 1)].view(np.uint16)
    inv = np.asarray(tb.inv_tri_np)
    for j in range(n - 1):
        at = j * (2 * n - j - 1) // 2
        eq(tri[at : at + n - 1 - j], inv[j, j + 1 :])


def test_mappings_and_launch_geometry(monkeypatch):
    """A thread a column for bases of at most 16 channels, else a warp;
    WARPS warps a block, fewer for a short batch; never more than
    BLOCKS_PER_SM blocks an SM."""
    assert [column_mapping(n) for n in (1, 8, 16, 17, 138, 448)] == [
        1, 1, 1, 32, 32, 32]
    monkeypatch.setattr(build, "sm_count", lambda device: 132)
    cap = mrc_mod.BLOCKS_PER_SM * 132
    dev = torch.device("cpu")
    assert launch_geometry(8, 1 << 22, dev) == (1, 8, cap)
    assert launch_geometry(138, 1, dev) == (32, 1, 1)
    assert launch_geometry(16, 3, dev) == (1, 1, 1)
    assert launch_geometry(16, 300, dev) == (1, 8, 2)
    assert launch_geometry(137, 1 << 20, dev) == (32, 8, cap)
    assert launch_geometry(137, 300, dev) == (32, 8, 38)
    monkeypatch.setattr(mrc_mod, "BLOCKS_PER_SM", 1)
    assert launch_geometry(137, 1 << 20, dev) == (32, 8, 132)


# ------------------------------------------ operands read where they lie
def _capture(monkeypatch, name):
    """Route ``ops``' ``name`` kernel call to a recorder on CPU tensors."""
    seen = []

    def fake(*args):
        seen.append(args)
        n, B = args[0].shape
        if name == "compare":
            return torch.zeros(B, dtype=torch.bool)
        return torch.zeros((B, n), dtype=torch.int32).T

    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, f"{name}_kernel_call", fake)
    return seen


def test_compare_op_reads_packed_divmod_rows_in_place(monkeypatch):
    """A divmod's comparison hands the kernel call views of the packed
    (..., n+1) rows themselves: base channels at stride 1 within a row of
    n+1 words, m_a the row's last word — no transposed copy."""
    tb = t_make_base(6, bits=15)
    n = tb.n
    p = torch.arange(3 * (n + 1), dtype=torch.int32).reshape(1, 3, n + 1)
    q = p.flip(1).contiguous()
    seen = _capture(monkeypatch, "compare")
    out = ops.compare_op(tb, p[..., :-1], p[..., -1], q[..., :-1], q[..., -1])
    assert out.shape == (1, 3) and out.dtype == torch.bool
    (x1t, a1, x2t, a2, image, ma), = seen
    assert ma == tb.ma and image.numel() == column_layout(n)["image"]
    for t, a, src in ((x1t, a1, p), (x2t, a2, q)):
        assert build.view_args(t) == [src.data_ptr(), 1, n + 1]
        assert build.view_args(a) == [src.data_ptr() + 4 * n, n + 1]
        assert t.untyped_storage().data_ptr() == src.untyped_storage().data_ptr()


def test_mrc_op_reads_channels_last_rows_in_place(monkeypatch):
    """The halving's parity MRC on the base channels of a (..., n+1)
    buffer, and an RnsArray's channels-last rows, reach the kernel call as
    views of their storage; an int64 operand is the one copy."""
    tb = t_make_base(5, bits=15)
    n = tb.n
    buf = torch.arange(4 * (n + 1), dtype=torch.int32).reshape(4, n + 1)
    seen = _capture(monkeypatch, "mrc")
    out = ops.mrc_op(tb, buf[..., :n])
    assert out.shape == (4, n) and out.dtype == torch.int32
    assert build.view_args(seen[-1][0]) == [buf.data_ptr(), 1, n + 1]
    cm = torch.zeros(n, 7, dtype=torch.int32)     # channel-major storage
    ops.mrc_op(tb, cm.T)
    assert build.view_args(seen[-1][0]) == [cm.data_ptr(), 7, 1]
    ops.mrc_op(tb, buf[..., :n].to(torch.int64))
    assert seen[-1][0].dtype == torch.int32


def test_column_kernel_calls_check_the_image():
    """A kernel call refuses an image of another base size, and CPU
    operands, before the library is loaded."""
    tb = t_make_base(3, bits=15)
    image = ops._column_image(tb, torch.device("cpu"))
    wrong = ops._column_image(t_make_base(12, bits=15), torch.device("cpu"))
    x = torch.zeros(3, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mrc_kernel_call(x, image)
    with pytest.raises(ValueError, match="table image"):
        mrc_mod.check_image("mrc", wrong, 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="channels"):
        mrc_mod.check_image("mrc", image, 449, torch.device("cpu"))


# ------------------------------------------------- on the card (skip here)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits,batch", [(2, 8, 4099), (8, 15, 4099),
                                          (16, 13, 33), (17, 13, 4099),
                                          (138, 15, 1), (138, 15, 300),
                                          (200, 15, 129), (448, 15, 7)])
def test_cuda_column_kernels_match_plain(card, n, bits, batch):
    """Both kernels against their plain versions on channels-last rows,
    channel-major tiles and packed (..., n+1) rows, in both mappings (a
    thread a column up to n = 16; a warp a column with 5 and with 14
    slots a lane) and on one column."""
    base = t_make_base(n, bits=bits)
    rng = np.random.default_rng(n + batch)
    m = np.asarray(base.moduli, np.int64)
    x1 = torch.from_numpy((rng.integers(0, 1 << 40, (batch, n)) % m)
                          .astype(np.int32)).to(card)
    x2 = torch.from_numpy((rng.integers(0, 1 << 40, (batch, n)) % m)
                          .astype(np.int32)).to(card)
    x2[: batch // 3] = x1[: batch // 3]
    with backend("torch"):
        A = RnsArray.from_parts(base, x1, device=card).normalize(Layout.BASE_MA)
        B = RnsArray.from_parts(base, x2, device=card).normalize(Layout.BASE_MA)
    image = ops._column_image(base, card)
    inv = base.tensor("inv_tri_np", card, torch.int32)
    mt = base.tensor("moduli_np", card, torch.int32)
    betas = base.tensor("betas_ma_np", card, torch.int32)
    pa, pb = A.to_packed(), B.to_packed()             # (batch, n + 1) rows
    for label, t1, t2 in (("rows", x1.T, x2.T),
                          ("tiles", x1.T.contiguous(), x2.T.contiguous()),
                          ("packed", pa[:, :n].T, pb[:, :n].T)):
        eq(mrc_kernel_call(t1, image), mrc_plain(t1, inv, mt))
        a1, a2 = pa[:, n], pb[:, n]
        got = compare_kernel_call(t1, a1, t2, a2, image, base.ma)
        assert got.dtype == torch.bool
        eq(got.to(torch.int32),
           compare_plain(t1, a1, t2, a2, inv, mt, betas, base.ma))
    eq(ops.compare_op(A, B), np.asarray(
        [rns_to_int(base, a) >= rns_to_int(base, b)
         for a, b in zip(x1.cpu().numpy(), x2.cpu().numpy())]))
    torch.cuda.synchronize()
