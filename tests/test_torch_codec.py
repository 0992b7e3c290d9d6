"""The port's gradient codec (``repro_torch.dist.grad_codec``, the codec
kernels of ``repro_torch.kernels`` and ``repro_torch.train.optimizer``)
against the reference's.

Every comparison feeds the same seeded numpy inputs to ``repro`` and to
``repro_torch``.  The reference's Pallas codec kernels run in interpret mode,
as its own tests run them.  On the CPU the port's wrappers run the kernels'
plain torch versions, the same arithmetic as the CUDA sources; tests marked
``cuda`` hold the CUDA kernels against those plain versions on the card and
skip on a host without one.

Tolerance: none, except for AdamW.  Residues, verdicts and fault reports
must be equal, and decoded f32 values equal bit for bit.  AdamW parameters
and moments agree to rtol 1e-6 plus an atol of 1e-6 times the array's
largest magnitude: ``pow``, ``cos``, ``sqrt`` and the norm's reduction order
may differ by an ulp between the two libraries, and a moment that two
opposite-sign steps nearly cancel carries that ulp of its terms.  The
gradients the optimizer decodes are equal bit for bit.
"""
import doctest
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.dist.fault import repair_packed as r_repair_packed
from repro.dist.grad_codec import GradCodec as RCodec
from repro.dist.grad_codec import tree_decode as r_tree_decode
from repro.dist.grad_codec import tree_pack as r_tree_pack
from repro.kernels import codec_decode_op as r_decode_op
from repro.kernels import codec_encode_op as r_encode_op
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.optimizer import adamw_init as r_adamw_init
from repro.train.optimizer import adamw_update as r_adamw_update
from repro_torch.core import RnsArray, backend
from repro_torch.dist import fault
from repro_torch.dist.grad_codec import (
    GradCodec,
    rns_psum,
    rns_psum_tree,
    tree_decode,
    tree_pack,
    tree_pack_rns,
)
from repro_torch.kernels import codec_decode_op, codec_encode_op, ops
from repro_torch.kernels.codec_decode import (
    codec_decode_kernel_call,
    codec_decode_plain,
)
from repro_torch.kernels.codec_encode import (
    codec_encode_kernel_call,
    codec_encode_plain,
)
from repro_torch.kernels.common import mod_mulhi
from repro_torch.train import AdamWConfig, adamw_init, adamw_update

ROOT = Path(__file__).resolve().parents[1]

# The parity sweep's codecs: detect codecs for 1, 8 and 512 replicas, the
# locate-and-correct codec, and the 8 x 6-bit base whose qmax >> 15 is far
# above m * 2**15 for its smallest modulus (31).
CODECS = {
    "w1": dict(world=1),
    "w8": dict(world=8),
    "w512": dict(world=512),
    "w8_rrns": dict(world=8, correct=True),
    "w1_n8b6": dict(world=1, n=8, bits=6),
}
BATCHES = [1, 7, 300]


def codecs(name):
    kw = CODECS[name]
    return RCodec.make(**kw), GradCodec.make(**kw)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.array(a))


def eq(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype == np.float32:  # bit for bit, NaN and -0.0 included
        got, want = got.view(np.int32), want.astype(np.float32).view(np.int32)
    np.testing.assert_array_equal(got, want)


def corners(clip: float) -> np.ndarray:
    """Every sign, clip and rounding corner the encode must get right."""
    c = np.float32(clip)
    up = np.nextafter(c, np.float32(np.inf))
    half = np.float32(2.0 ** -17)  # half a quantization step at 16 bits
    return np.asarray(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, c, -c, up, -up,
         np.nextafter(c, np.float32(0)), 1e30, -1e30, half, -half, 3 * half,
         -3 * half, 5 * half, 1e-9, -1e-9, 1e-40, -1e-40], np.float32)


def grads(codec, batch, seed) -> np.ndarray:
    """``batch`` gradients: normal mass, values that clip, and the corners."""
    rng = np.random.default_rng(seed)
    g = np.concatenate([
        rng.standard_normal(batch).astype(np.float32),
        (rng.standard_normal(batch) * 4 * codec.clip).astype(np.float32),
        corners(codec.clip),
    ])
    return g[rng.permutation(len(g))[:max(batch, 1)]] if batch < 40 else g


# ------------------------------------------------------------ construction
@pytest.mark.parametrize("name", CODECS)
def test_make_matches_reference(name):
    rc, tc = codecs(name)
    assert tc.base.moduli == tuple(rc.base.moduli) and tc.base.ma == rc.base.ma
    assert tc.mb == rc.mb and tc.redundant == rc.redundant
    assert tc.qmax == rc.qmax and tc.clip == rc.clip
    assert tc.n_channels == rc.n_channels and tc.use_fused == rc.use_fused
    assert tc.layout.value == rc.layout.value


def test_use_fused_gate_and_backend_override():
    assert GradCodec.make(world=2).use_fused
    assert not GradCodec.make(world=2, n=4).use_fused          # M ~ 2**60
    assert not GradCodec.make(world=2, n=2, bits=20).use_fused  # wide lanes
    off = GradCodec.make(world=2, fused=False)
    assert not off.use_fused
    with backend("cuda"):
        assert off.use_fused
        with pytest.raises(ValueError, match="CUDA tensor"):
            off.encode_packed(torch.ones(3))
    with backend("torch"):
        assert not GradCodec.make(world=2).use_fused


def test_codec_kernels_reject_wide_bases():
    for codec in (GradCodec.make(world=2, n=4), GradCodec.make(world=2, n=2,
                                                               bits=20)):
        with pytest.raises(ValueError):
            codec_encode_op(codec, torch.ones(4))
        with pytest.raises(ValueError):
            codec_decode_op(codec, torch.zeros(4, codec.n_channels,
                                               dtype=torch.int32))
    with pytest.raises(ValueError, match="2\\*\\*45"):
        codec_encode_op(GradCodec.make(world=2, n=4), torch.ones(4))


# ---------------------------------------------------- encode: plain kernel
@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("batch", BATCHES)
def test_encode_plain_matches_reference(name, batch):
    rc, tc = codecs(name)
    g = grads(rc, batch, seed=batch)
    want = np.asarray(r_encode_op(rc, J(g), interpret=True))
    eq(codec_encode_op(tc, T(g)), want)                       # plain kernel
    eq(np.asarray(rc.encode(J(g))), want)                     # reference f64
    eq(tc.encode(T(g)), want)                                 # port f64
    eq(codec_encode_op(tc, T(g), channel_major=True), want.T)
    eq(tc.encode_packed(T(g).reshape(1, -1), channel_major=True), want.T)
    with backend("torch"):                                    # f64 fallback
        eq(tc.encode_packed(T(g).reshape(1, -1), channel_major=True), want.T)


@pytest.mark.parametrize("name", CODECS)
def test_encode_nan_is_zero_and_inf_clips(name):
    rc, tc = codecs(name)
    g = np.float32([np.nan, -np.nan, np.inf, -np.inf])
    for out in (codec_encode_op(tc, T(g)), tc.encode(T(g))):
        assert not out[:2].any()
        eq(out[2:], tc.encode(torch.tensor([tc.clip, -tc.clip],
                                           dtype=torch.float64)))
    eq(codec_encode_op(tc, T(g)), np.asarray(r_encode_op(rc, J(g),
                                                         interpret=True)))


def test_encode_property_representable_bounds():
    """Hypothesis over every f32 between the representable bounds
    +-float32(1e30) (the nearest f32 to 1e30, so the strategy accepts them)."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    bound = float(np.float32(1e30))
    rc, tc = codecs("w8")

    @hyp.settings(max_examples=150, deadline=None)
    @hyp.given(st.lists(st.floats(-bound, bound, width=32), min_size=16,
                        max_size=16))
    def check(vals):
        g = np.asarray(vals, np.float32)
        eq(codec_encode_op(tc, T(g)), np.asarray(rc.encode(J(g))))

    check()


def test_f32_barrett_range_on_the_encode_high_limb():
    """The f32 Barrett step (one correction each way) is proven for
    t < m * 2**15.  On the 8 x 6-bit codec the encode's high limb reaches
    qh = qmax >> 15 = 276,624,966: over the top 2**22 values below qh (the
    f32 rounding error grows with t) the step is still exact for every
    channel, but below 2**29, inside the range the reference's
    ``common.py`` claims, it is not for its three smallest moduli.  The
    multiply-high step the port uses is exact on both ranges."""
    from repro_torch.kernels.common import barrett_mod, recip

    codec = GradCodec.make(world=1, n=8, bits=6)
    qh = codec.qmax >> 15
    assert qh == 276_624_966
    near_qh = torch.arange(qh - (1 << 22), qh + 1, dtype=torch.int32)
    near_2_29 = torch.arange((1 << 29) - (1 << 22), 1 << 29, dtype=torch.int32)
    wrong = {}
    for m in tuple(codec.base.moduli) + codec.redundant:
        mt = torch.tensor(m, dtype=torch.int32)
        for t in (near_qh, near_2_29):
            exact = torch.remainder(t, m)
            eq(mod_mulhi(t, mt), exact)
            n_wrong = int((barrett_mod(t, mt, recip(mt)) != exact).sum())
            if t is near_qh:
                assert n_wrong == 0, m
            elif n_wrong:
                wrong[m] = n_wrong
    assert wrong == {37: 177_118, 31: 2_114, 29: 205_646}


def test_mod_mulhi_is_exact_where_barrett_is_not():
    m = T(np.asarray([[31], [37], [61], [32749]], np.int32))
    t = T(np.asarray([0, 1, 30, 31, (1 << 29) - 1, 276_624_966,
                      (1 << 31) - 1], np.int32))[None, :]
    eq(mod_mulhi(t, m), torch.remainder(t.to(torch.int64), m).to(torch.int32))


# ---------------------------------------------------- decode: plain kernel
def summed_buffers(rc, batch, seed) -> np.ndarray:
    """Per-channel sums of up to 8 replicas' encodings, with the extreme
    sums +-qmax * world in the last two columns."""
    reps = min(rc.world, 8)
    enc = [np.asarray(rc.encode(J(grads(rc, batch, seed + r)))).astype(np.int64)
           for r in range(reps)]
    ext = np.asarray(rc.encode(J(np.float32([rc.clip, -rc.clip]) * 2)))
    s = np.concatenate([sum(enc), ext.astype(np.int64) * rc.world])
    return s.astype(np.int32)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("batch", BATCHES)
def test_decode_plain_matches_reference(name, batch):
    rc, tc = codecs(name)
    s = summed_buffers(rc, batch, seed=batch)
    want = np.asarray(r_decode_op(rc, J(s), interpret=True))
    eq(want, np.asarray(rc.decode(rc.fold(J(s)))))            # reference pair
    eq(codec_decode_op(tc, T(s)), want)                       # plain kernel
    eq(codec_decode_op(tc, T(s.T.copy()), channel_major=True), want)
    eq(tc.decode(tc.fold(T(s))), want)                        # port f64
    eq(tc.decode_summed(T(s)), want)
    eq(tc.decode_summed(tc.as_array(T(s.T.copy()), channel_major=True)), want)
    with backend("torch"):
        eq(tc.decode_summed(T(s.T.copy()), channel_major=True), want)


def test_decode_extreme_sums_are_plus_minus_clip_times_world():
    rc, tc = codecs("w512")
    s = summed_buffers(rc, 4, seed=0)
    out = codec_decode_op(tc, T(s))[-2:] / tc.world
    eq(out, np.float32([tc.qmax, -tc.qmax]) / 65536)


def test_cpu_codec_ops_count_no_launch():
    ops.reset_launches()
    tc = GradCodec.make(world=4)
    codec_decode_op(tc, codec_encode_op(tc, torch.ones(5)))
    counts = ops.reset_launches()
    assert counts["codec_encode_op"] == 0 and counts["codec_decode_op"] == 0


def test_codec_kernel_calls_reject_host_tensors():
    tc = GradCodec.make(world=4)
    m, p, o = ops._encode_tables(tc.base, tc.redundant)
    with pytest.raises(ValueError, match="CUDA"):
        codec_encode_kernel_call(torch.ones(8), m, p, o, scale=65536.0,
                                 qh=1, ql=0)
    dm, inv, half = ops._decode_tables(tc.base)
    with pytest.raises(ValueError, match="CUDA"):
        codec_decode_kernel_call(torch.zeros(4, 8, dtype=torch.int32), dm, inv,
                                 half, inv_scale=2.0 ** -16)
    with pytest.raises(ValueError):
        codec_decode_kernel_call(torch.zeros(2, 8, dtype=torch.int32), dm, inv,
                                 half, inv_scale=2.0 ** -16)


# ------------------------------------------------ algebra on packed buffers
@pytest.mark.parametrize("name", CODECS)
def test_fold_normalize_verify_and_queries_match_reference(name):
    rc, tc = codecs(name)
    s = summed_buffers(rc, 300, seed=3)
    fr, ft = rc.fold(J(s)), tc.fold(T(s))
    eq(ft, np.asarray(fr))
    eq(tc.normalize(ft), np.asarray(rc.normalize(fr)))
    eq(tc.verify_packed(ft), np.asarray(rc.verify_packed(fr)))
    nr, nt = rc.normalize(fr), tc.normalize(ft)
    eq(tc.is_negative(nt), np.asarray(rc.is_negative(nr)))
    thr = rc.qmax // 3
    eq(tc.abs_ge(nt, thr), np.asarray(rc.abs_ge(nr, thr)))
    eq(tc.range_ok(nt, nt.flip(0)), np.asarray(rc.range_ok(nr, nr[::-1])))
    # typed in, typed out, same residues
    arr = tc.as_array(ft)
    assert isinstance(tc.normalize(arr), RnsArray)
    eq(tc.normalize(arr).residues, np.asarray(rc.normalize(fr)))


def test_verify_flags_a_corrupted_channel_like_the_reference():
    rc, tc = codecs("w8_rrns")
    buf = np.asarray(rc.encode(J(grads(rc, 300, seed=1))))
    bad = buf.copy()
    bad[::3, 1] = (bad[::3, 1] + 7) % rc.base.moduli[1]
    eq(tc.verify_packed(T(bad)), np.asarray(rc.verify_packed(J(bad))))
    assert not tc.verify_packed(T(bad)).all()


def rrns_cases(rc, seed):
    """A clean RRNS buffer and copies with single-channel faults on every
    channel at chosen elements, plus one two-channel fault."""
    buf = np.asarray(rc.encode(J(grads(rc, 300, seed=seed))))
    chans = tuple(rc.base.moduli) + rc.redundant
    bad = buf.copy()
    rows = np.arange(len(buf))
    for c, m in enumerate(chans):
        sel = rows[c::len(chans) + 1]
        bad[sel, c] = (bad[sel, c] + 1 + c) % m
    two = buf.copy()
    two[5, 0] = (two[5, 0] + 3) % chans[0]
    two[5, 2] = (two[5, 2] + 4) % chans[2]
    return buf, bad, two


@pytest.mark.parametrize("wraps", [0, 7])
def test_locate_correct_and_repair_match_reference(wraps):
    rc, tc = codecs("w8_rrns")
    buf, bad, two = rrns_cases(rc, seed=2)
    if wraps:  # a post-psum buffer: per-channel sums of world - 1 + 1 copies
        buf = buf.astype(np.int64) * (wraps + 1)
        buf = np.asarray(rc.fold(J(buf.astype(np.int32))))
        bad = buf.copy()
        chans = tuple(rc.base.moduli) + rc.redundant
        for c, m in enumerate(chans):
            bad[c::len(chans) + 1, c] = (bad[c::len(chans) + 1, c] + 1 + c) % m
    for x in (buf, bad, two):
        eq(tc.locate_fault(T(x), wraps=wraps),
           np.asarray(rc.locate_fault(J(x), wraps=wraps)))
        fixed_t, fault_t = tc.correct_packed(T(x), wraps=wraps)
        fixed_r, fault_r = rc.correct_packed(J(x), wraps=wraps)
        eq(fixed_t, np.asarray(fixed_r))
        eq(fault_t, np.asarray(fault_r))
        got, rep = fault.repair_packed(tc, T(x.T.copy()), wraps=wraps,
                                       channel_major=True)
        want, rep_r = r_repair_packed(rc, J(x.T.copy()), wraps=wraps,
                                      channel_major=True)
        eq(got, np.asarray(want))
        assert rep == rep_r
    if wraps == 0:  # exact location: every channel repaired, buffer restored
        fixed, fault_t = tc.correct_packed(T(bad))
        eq(fixed, buf)
        assert set(fault_t.tolist()) == {-1, *range(tc.n_channels)}
        assert tc.locate_fault(T(two))[5] == -2


def test_correct_packed_on_typed_wire_array():
    rc, tc = codecs("w8_rrns")
    buf, bad, _ = rrns_cases(rc, seed=4)
    arr = tc.as_array(T(bad.T.copy()), channel_major=True)
    fixed, rep = fault.repair_packed(tc, arr)
    assert isinstance(fixed, RnsArray) and fixed.channel_axis == 0
    eq(fixed.residues, buf.T)
    assert rep == {"repaired": int((tc.locate_fault(T(bad)) >= 0).sum()),
                   "unrecoverable": 0}


def test_locate_requires_second_redundant_and_valid_wraps():
    tc = GradCodec.make(world=8)
    with pytest.raises(ValueError, match="correct=True"):
        tc.locate_fault(torch.zeros(3, 4, dtype=torch.int32))
    rrns = GradCodec.make(world=8, correct=True)
    with pytest.raises(ValueError, match="wraps"):
        rrns.locate_fault(torch.zeros(3, 5, dtype=torch.int32), wraps=10 ** 9)


# ---------------------------------------------------- bucketed transport
def unsorted_tree(rng):
    """A nested gradient tree whose keys are NOT inserted in sorted order,
    with a bf16 leaf, a 0-d leaf, a list and a None."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"zeta": f(3, 5), "alpha": {"w": f(7), "b": [f(2, 2), f()]},
            "mid": {"bf": f(4, 3), "none": None}}


def to_torch(tree):
    out = {"zeta": T(tree["zeta"]),
           "alpha": {"w": T(tree["alpha"]["w"]),
                     "b": [T(x) for x in tree["alpha"]["b"]]},
           "mid": {"bf": T(tree["mid"]["bf"]).to(torch.bfloat16), "none": None}}
    return out


def to_jax(tree):
    return {"zeta": J(tree["zeta"]),
            "alpha": {"w": J(tree["alpha"]["w"]),
                      "b": [J(x) for x in tree["alpha"]["b"]]},
            "mid": {"bf": J(tree["mid"]["bf"]).astype(jnp.bfloat16),
                    "none": None}}


def leaves_np(tree):
    from repro_torch.dist._tree import flatten_named

    out = {}
    for name, leaf in flatten_named(tree):
        if isinstance(leaf, torch.Tensor):
            out[name] = (str(leaf.dtype).replace("torch.", ""),
                         leaf.to(torch.float32).numpy())
        else:
            out[name] = (str(leaf.dtype), np.asarray(leaf, np.float32))
    return out


@pytest.mark.parametrize("name", ["w8", "w8_rrns"])
def test_tree_pack_layout_and_roundtrip_match_reference(name):
    rc, tc = codecs(name)
    tree = unsorted_tree(np.random.default_rng(0))
    buf_r, meta_r = r_tree_pack(rc, to_jax(tree))
    buf_t, meta_t = tree_pack(tc, to_torch(tree))
    eq(buf_t, np.asarray(buf_r))
    assert buf_t.is_contiguous()
    back_r = r_tree_decode(rc, buf_r, meta_r, denom=1.0)
    back_t = tree_decode(tc, buf_t, meta_t, denom=1.0)
    lr, lt = leaves_np(back_r), leaves_np(back_t)
    assert list(lr) == list(lt) == ["alpha/b/[0]", "alpha/b/[1]", "alpha/w",
                                    "mid/bf", "zeta"]
    for k in lr:
        assert lr[k][0] == lt[k][0]
        eq(lt[k][1], lr[k][1])
    assert back_t["mid"]["none"] is None
    arr, _ = tree_pack_rns(tc, to_torch(tree))
    assert arr.channel_axis == 0 and arr.layout is tc.layout
    eq(arr.residues, np.asarray(buf_r))


@pytest.mark.parametrize("make", [dict(world=8), dict(world=8, correct=True),
                                  dict(world=2, n=4)])   # n=4: the f64 path
def test_tree_pack_into_a_given_wire(make):
    """``tree_pack_rns(out=)`` writes the same residues as a fresh pack
    into the given buffer; ``out=`` takes the channel-major layout only."""
    tc = GradCodec.make(**make)
    tree = to_torch(unsorted_tree(np.random.default_rng(1)))
    fresh, _ = tree_pack_rns(tc, tree)
    out = torch.full(tuple(fresh.residues.shape), -1, dtype=torch.int32)
    got, _ = tree_pack_rns(tc, tree, out=out)
    assert got.residues.data_ptr() == out.data_ptr()
    eq(got.residues, fresh.residues.numpy())
    with pytest.raises(ValueError, match="channel-major"):
        tc.encode_packed(torch.ones(6), out=out)


def test_tree_pack_rejects_empty_tree():
    with pytest.raises(ValueError, match="empty"):
        tree_pack(GradCodec.make(world=2), {"a": None, "b": []})


def test_as_array_keeps_a_host_buffer_on_the_host():
    tc = GradCodec.make(world=8, correct=True)
    buf = tc.encode_packed(torch.ones(6), channel_major=True)
    arr = tc.as_array(buf, channel_major=True)
    assert arr.device == buf.device == torch.device("cpu")
    assert tc.encode_array(torch.ones(6)).device.type == "cpu"


@pytest.fixture(scope="module")
def gloo1():
    """A one-rank gloo process group over an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["w1", "w8_rrns"])
def test_rns_psum_one_rank_matches_reference(gloo1, name):
    rc, tc = codecs(name)
    g = grads(rc, 300, seed=5).reshape(-1, 1)
    want = np.asarray(rc.decode_summed(rc.encode_packed(J(g)))) / np.float32(1)
    eq(rns_psum(tc, T(g), group=gloo1), want)
    tree = unsorted_tree(np.random.default_rng(1))
    out = rns_psum_tree(tc, to_torch(tree), group=gloo1)
    buf_r, meta_r = r_tree_pack(rc, to_jax(tree))
    want = leaves_np(r_tree_decode(rc, buf_r, meta_r, denom=1.0))
    for k, (dtype, v) in leaves_np(out).items():
        assert dtype == want[k][0]
        eq(v, want[k][1])


def test_rns_psum_tree_two_ranks_matches_reference(tmp_path):
    """Two gloo ranks in subprocesses over a FileStore: each sums the other's
    gradients through the transport, equal to the reference's encode ->
    sum -> decode / 2."""
    rc = RCodec.make(world=2, correct=True)
    rngs = [np.random.default_rng(10 + r) for r in range(2)]
    trees = [unsorted_tree(rng) for rng in rngs]
    flat = [np.concatenate([v.ravel() for v in (t["alpha"]["b"][0],
                                                t["alpha"]["b"][1],
                                                t["alpha"]["w"],
                                                t["mid"]["bf"], t["zeta"])])
            for t in trees]
    for r in range(2):
        np.save(tmp_path / f"g{r}.npy", flat[r])
    child = (
        "import sys, numpy as np, torch, torch.distributed as dist\n"
        "from repro_torch.dist.grad_codec import GradCodec, rns_psum_tree\n"
        "rank, d = int(sys.argv[1]), sys.argv[2]\n"
        "dist.init_process_group('gloo', store=dist.FileStore(d + '/store', 2),"
        " rank=rank, world_size=2)\n"
        "f = torch.from_numpy(np.load(f'{d}/g{rank}.npy'))\n"
        "tree = {'zeta': f[24:39].reshape(3, 5), 'alpha': {'w': f[5:12],"
        " 'b': [f[:4].reshape(2, 2), f[4].reshape(())]},"
        " 'mid': {'bf': f[12:24].reshape(4, 3), 'none': None}}\n"
        "out = rns_psum_tree(GradCodec.make(world=2, correct=True), tree)\n"
        "np.save(f'{d}/out{rank}.npy', torch.cat([out['alpha']['b'][0].ravel(),"
        " out['alpha']['b'][1].ravel(), out['alpha']['w'],"
        " out['mid']['bf'].ravel(), out['zeta'].ravel()]).numpy())\n"
        "dist.destroy_process_group()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r),
                               str(tmp_path)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    # the leaf "mid/bf" is a float32 leaf here; the flat layout is the
    # sorted-key order, so the reference sums the same flat rows
    summed = sum(np.asarray(rc.encode_packed(J(f), channel_major=True))
                 .astype(np.int64) for f in flat).astype(np.int32)
    want = np.asarray(rc.decode_summed(J(summed), channel_major=True)) / \
        np.float32(2)
    for r in range(2):
        eq(np.load(tmp_path / f"out{r}.npy"), want)


# ------------------------------------------------- AdamW at the boundary
def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_adamw_three_steps_with_codec_decode_match_reference():
    rng = np.random.default_rng(7)
    shapes = {"embed": (11, 6), "final_norm": (6,),
              "layers": {"attn": {"wq": (2, 6, 4)}, "ln1": (2, 6)}}

    def make(fn, tree=shapes):
        if isinstance(tree, dict):
            return {k: make(fn, v) for k, v in tree.items()}
        return fn(tree)

    p_np = make(lambda s: rng.standard_normal(s).astype(np.float32))
    conv = lambda f, t: {k: conv(f, v) if isinstance(v, dict) else f(v)
                         for k, v in t.items()}
    pr, pt = conv(J, p_np), conv(T, p_np)
    rcfg = RAdamWConfig(warmup=2, decay_steps=10)
    tcfg = AdamWConfig(warmup=2, decay_steps=10)
    sr, st_ = r_adamw_init(pr), adamw_init(pt)
    rc, tc = codecs("w8")
    for step in range(3):
        g_np = make(lambda s: (rng.standard_normal(s) * 0.3).astype(np.float32))
        buf_r, meta_r = r_tree_pack(rc, conv(J, g_np))
        arr_t, meta_t = tree_pack_rns(tc, conv(T, g_np))
        eq(arr_t.residues, np.asarray(buf_r))
        seen = {}

        def dec(s):
            seen["g"] = tree_decode(tc, s, meta_t, denom=1.0)
            return seen["g"]

        pr, sr, nr = r_adamw_update(
            rcfg, pr, buf_r, sr,
            grad_decode=lambda s: r_tree_decode(rc, s, meta_r, denom=1.0))
        pt, st_, nt = adamw_update(tcfg, pt, arr_t, st_, grad_decode=dec)
        want_g = r_tree_decode(rc, buf_r, meta_r, denom=1.0)
        eq(seen["g"]["embed"], np.asarray(want_g["embed"]))
        eq(seen["g"]["layers"]["attn"]["wq"],
           np.asarray(want_g["layers"]["attn"]["wq"]))
        np.testing.assert_allclose(float(nt), float(nr), rtol=1e-6)
        assert int(st_["step"]) == int(sr["step"]) == step + 1
        for key in ("embed", "final_norm"):
            for got, want in ((pt[key], pr[key]), (st_["m"][key], sr["m"][key]),
                              (st_["v"][key], sr["v"][key])):
                close(got, want)
        close(pt["layers"]["attn"]["wq"], pr["layers"]["attn"]["wq"])
    assert list(pt) == ["embed", "final_norm", "layers"]


def test_adamw_master_copy_and_bf16_params():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p, master=True)
    assert st["master"]["w"].dtype == torch.float32
    new, st2, _ = adamw_update(AdamWConfig(), p, {"w": torch.ones(4)}, st)
    assert new["w"].dtype == torch.bfloat16 and st2["master"]["w"].dtype == \
        torch.float32
    with pytest.raises(ValueError, match="structure"):
        adamw_update(AdamWConfig(), p, {"w": [torch.ones(4)]}, st)


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The non-view aten ops a block runs, by name (``mul`` for ``mul``,
    ``mul_`` and ``mul.out`` alike, ``copy`` for ``copy_`` and a cast's
    ``_to_copy``: one kernel each on the card)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            name = func.overloadpacket.__name__.strip("_")
            self.names.append("copy" if name == "to_copy" else name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype,master", [
    (torch.float32, False), (torch.bfloat16, True),
    (torch.bfloat16, False), (torch.float32, True)])
def test_adamw_into_a_dead_buffer(dtype, master):
    """``adamw_update(out=buf)``: the new parameters, masters and moments
    are views of ``buf``'s bytes, equal bit for bit to the fresh tensors of
    the same update from the same ops, and the inputs are not written to;
    a buffer too small for them gives fresh tensors."""
    g = torch.Generator().manual_seed(5)
    shapes = {"a": (3, 5), "b": (7,), "c": ()}
    p = {k: torch.randn(s, generator=g).to(dtype) for k, s in shapes.items()}
    st = adamw_init(p, master=master)
    st["m"] = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    st["v"] = {k: torch.rand(s, generator=g) for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    cfg = AdamWConfig(warmup=2)
    keep = [t.clone() for t in (*p.values(), *st["m"].values(),
                                *st["v"].values())]
    with _Ops() as fresh_ops:
        want = adamw_update(cfg, p, grads, st)
    buf = torch.full((4, 1024), -1, dtype=torch.int32)
    with _Ops() as out_ops:
        got = adamw_update(cfg, p, grads, st, out=buf)
    assert sorted(out_ops.names) == sorted(fresh_ops.names)
    ptr = buf.untyped_storage().data_ptr()
    trees = lambda r: [r[0], r[1]["m"], r[1]["v"]] + (
        [r[1]["master"]] if master else [])
    for tree_got, tree_want in zip(trees(got), trees(want)):
        for k in shapes:
            assert tree_got[k].untyped_storage().data_ptr() == ptr
            assert tree_got[k].dtype == tree_want[k].dtype
            assert tree_got[k].shape == tree_want[k].shape
            assert torch.equal(tree_got[k], tree_want[k]), k
    assert torch.equal(got[2], want[2])
    for t, old in zip((*p.values(), *st["m"].values(), *st["v"].values()),
                      keep):
        assert torch.equal(t, old)
    small = adamw_update(cfg, p, grads, st,
                         out=torch.zeros(16, dtype=torch.int32))
    for k in shapes:
        assert small[0][k].untyped_storage().data_ptr() != ptr
        assert torch.equal(small[0][k], want[0][k])


# ------------------------------------------------------------- doctests
@pytest.mark.parametrize("name", ["repro_torch.dist.grad_codec",
                                  "repro_torch.dist._tree"])
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
@pytest.mark.parametrize("name", CODECS)
def test_cuda_codec_kernels_match_plain(card, name):
    _, tc = codecs(name)
    g = T(grads(tc, 4099, seed=11)).to(card)
    m, p, o = ops._encode_tables(tc.base, tc.redundant)
    kw = dict(scale=65536.0, qh=tc.qmax >> 15, ql=tc.qmax & 0x7FFF)
    enc = codec_encode_kernel_call(g, m, p, o, **kw)
    eq(enc, codec_encode_plain(g, m, p, o, **kw))
    s = (enc * tc.world).contiguous()
    dm, inv, half = ops._decode_tables(tc.base)
    eq(codec_decode_kernel_call(s, dm, inv, half, inv_scale=2.0 ** -16),
       codec_decode_plain(s, dm, inv, half, inv_scale=2.0 ** -16))
    torch.cuda.synchronize()
