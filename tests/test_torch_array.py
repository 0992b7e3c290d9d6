"""``repro_torch.core.RnsArray`` and the backend resolver against the
reference ``repro.core.RnsArray``.

State crosses between the packages through ``RnsArray.from_numpy``: each
reference value's fields, as numpy data, rebuild the port's value on the
CPU.  Tolerance: none — residues, digits, verdicts, m_a channels, quotients
and remainders must match exactly (``assert_array_equal``); the hypothesis
property checks ``>=`` against Python integers.
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.core import Layout as RLayout, RnsArray as RArray
from repro.core.base import make_base as r_make_base
from repro_torch.core import Layout, RnsArray, backend, get_backend, make_base
from repro_torch.core.dispatch import resolve_backend

MB = 32603  # a second redundant modulus for the RRNS layout (15-bit prime)


def eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def port(ra: RArray) -> RnsArray:
    """The reference value, rebuilt in the port from its numpy fields."""
    b = ra.base
    return RnsArray.from_numpy(
        b.moduli_np, b.ma, b.bits, np.asarray(ra.residues), layout=ra.layout,
        signed=ra.signed, channel_axis=ra.channel_axis, mb=ra.mb, device="cpu")


def same(ta: RnsArray, ra: RArray):
    assert (ta.layout.value, ta.signed, ta.channel_axis, ta.mb) == (
        ra.layout.value, ra.signed, ra.channel_axis, ra.mb)
    assert ta.shape == tuple(ra.shape) and ta.n_channels == ra.n_channels
    eq(ta.residues, ra.residues)


def draw(base, k, rng):
    vals = [int.from_bytes(rng.bytes(16), "little") % base.M for _ in range(k)]
    vals[:3] = [0, base.M - 1, base.M // 2]
    return vals


def ref_pair(layout, channel_axis, bits=8, k=24, seed=0):
    rb = r_make_base(4, bits=bits)
    rng = np.random.default_rng(seed)
    v1, v2 = draw(rb, k, rng), draw(rb, k, rng)
    v2[3:6] = v1[3:6]
    v1 = [v % (1 << 62) for v in v1]
    v2 = [v % (1 << 62) for v in v2]
    mb = MB if layout is RLayout.RRNS else None
    mk = lambda v: RArray.encode(rb, jnp.asarray(v), layout=layout, mb=mb,  # noqa: E731
                                 channel_axis=channel_axis)
    return mk(v1), mk(v2), v1, v2


LAYOUTS = [(lay, ax) for lay in (RLayout.BASE, RLayout.BASE_MA, RLayout.RRNS)
           for ax in (-1, 0)]


@pytest.mark.parametrize("layout,axis", LAYOUTS)
def test_ring_operators_and_views(layout, axis):
    ra, rc, _, _ = ref_pair(layout, axis)
    a, c = port(ra), port(rc)
    same(a, ra)
    for op in (lambda p, q: p + q, lambda p, q: p - q, lambda p, q: p * q,
               lambda p, q: -p, lambda p, q: p + 5, lambda p, q: 7 - p,
               lambda p, q: 3 * p, lambda p, q: p * (q + 1)):
        same(op(a, c), op(ra, rc))
    eq(a.x, ra.x)
    eq(a.to_packed(), ra.to_packed())
    eq(a.channel_moduli, ra.channel_moduli)
    same(a.with_channel_axis(-1 - axis), ra.with_channel_axis(-1 - axis))
    eq(a.to_mrs(), ra.to_mrs())
    eq(a.to_int(), ra.to_int())
    eq(a.extend((101, 127)), ra.extend((101, 127)))
    if layout is not RLayout.BASE:
        eq(a.xa, ra.xa)
        eq(a.to("cpu").residues, a.residues)


@pytest.mark.parametrize("layout,axis", LAYOUTS[2:])
def test_comparisons_and_division(layout, axis):
    ra, rc, v1, v2 = ref_pair(layout, axis, seed=3)
    a, c = port(ra), port(rc)
    for op in (lambda p, q: p >= q, lambda p, q: p <= q, lambda p, q: p > q,
               lambda p, q: p < q, lambda p, q: p >= 1000,
               lambda p, q: p.compare_ge(q, unroll=True)):
        eq(op(a, c), op(ra, rc))
    eq(a >= c, [x >= y for x, y in zip(v1, v2)])
    same(a.halve(), ra.halve())
    same(a.scale_pow2(3), ra.scale_pow2(3))
    d = c + 1                                  # nonzero divisors
    (tq, tr), (rq, rr) = a.divmod(d), ra.divmod(rc + 1)
    same(tq, rq)
    same(tr, rr)


def test_normalize_between_layouts():
    rb = r_make_base(5, bits=15)
    rng = np.random.default_rng(5)
    x = rng.integers(0, rb.moduli_np, size=(24, 5)).astype(np.int32)
    ra = RArray.from_parts(rb, jnp.asarray(x))
    a = port(ra)
    for lay, mb in ((RLayout.BASE_MA, None), (RLayout.RRNS, MB),
                    (RLayout.BASE, None)):
        same(a.normalize(Layout(lay.value), mb=mb), ra.normalize(lay, mb=mb))
    wrapped = port(ra.normalize(RLayout.BASE_MA)) * 40000   # wraps mod M
    same(wrapped.normalize(), ra.normalize(RLayout.BASE_MA).__mul__(40000)
         .normalize())
    with pytest.raises(ValueError):
        a.normalize(Layout.RRNS)


def test_signed_values():
    rb = r_make_base(4, bits=15)
    rng = np.random.default_rng(8)
    half = rb.M // 2
    v = rng.integers(-half + 1, half, size=24, dtype=np.int64)
    v[:4] = [0, -1, 1, -half + 1]
    ra = RArray.encode_signed(rb, jnp.asarray(v))
    a = RnsArray.encode_signed(make_base(4, bits=15), v, device="cpu")
    same(a, ra)
    same(port(ra), ra)
    eq(a.is_negative(), ra.is_negative())
    eq(a.abs_ge(12345), ra.abs_ge(12345))
    eq(a.to_int(), v)
    with pytest.raises(ValueError):
        a.halve()
    with pytest.raises(ValueError):
        port(RArray.encode(rb, jnp.asarray([3]))).is_negative()


def test_constructors_and_validation():
    tb = make_base(4, bits=8)
    a = RnsArray.encode(tb, [1234, 5], layout=Layout.RRNS, mb=MB, device="cpu")
    eq(a.residues[:, -1], [1234 % MB, 5])
    b = RnsArray.from_packed(tb, a.residues, mb=MB, device="cpu")
    assert b.layout is Layout.RRNS
    same(RnsArray.from_parts(tb, a.x, a.xa, device="cpu"),
         RArray.from_parts(r_make_base(4, bits=8), jnp.asarray(a.x.numpy()),
                           jnp.asarray(a.xa.numpy())))
    with pytest.raises(ValueError):
        RnsArray(torch.zeros(3, 6, dtype=torch.int32), tb)   # 6 != n + 1
    with pytest.raises(ValueError):
        RnsArray(torch.zeros(3, 5, dtype=torch.int32), tb, channel_axis=1)
    with pytest.raises(ValueError):
        RnsArray(torch.zeros(3, 6, dtype=torch.int32), tb, layout=Layout.RRNS)
    with pytest.raises(ValueError):
        RnsArray.from_packed(tb, torch.zeros(3, 9, dtype=torch.int32), device="cpu")
    with pytest.raises(ValueError):
        RnsArray.encode(tb, [1], layout=Layout.RRNS, device="cpu")
    with pytest.raises(ValueError):
        RnsArray.from_parts(tb, [[1, 2, 3, 4]], device="cpu").compare_ge(0)
    with pytest.raises(ValueError):
        a + RnsArray.encode(make_base(4, bits=13), [1], device="cpu")
    with pytest.raises(ValueError):
        a + RnsArray.encode(tb, [1], device="cpu")       # layouts differ


def test_constructors_default_to_the_card(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = make_base(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        RnsArray.encode(tb, [1, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        RnsArray.from_parts(tb, [[1, 2, 3]])
    with pytest.raises(RuntimeError, match="CUDA"):
        RnsArray.from_numpy(tb.moduli, tb.ma, tb.bits, np.zeros((2, 4), np.int32))


def test_backend_resolver():
    tb, wide = make_base(3), make_base(3, bits=31)
    x = torch.zeros(2, 3, dtype=torch.int32)
    assert get_backend() == "auto"
    assert resolve_backend(x, tb) == "torch"             # CPU tensor
    assert resolve_backend(x.to(torch.int64), wide) == "torch"
    with backend("torch"):
        assert get_backend() == "torch" and resolve_backend(x, tb) == "torch"
    with backend("cuda"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            resolve_backend(x, tb)
        a = RnsArray.encode(tb, [5, 9], device="cpu")
        with pytest.raises(ValueError):
            a >= a
        with pytest.raises(ValueError):
            a.to_mrs()
        seen = []
        t = threading.Thread(target=lambda: seen.append(get_backend()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == ["auto"]     # thread-local
    assert get_backend() == "auto"
    with pytest.raises(ValueError):
        with backend("pallas"):
            pass


def test_ge_is_the_integer_order_property():
    """Random Python ints below M: the port's >= equals the truth."""
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies
    tb = make_base(6, bits=15)

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(st.lists(st.tuples(st.integers(0, tb.M - 1),
                                  st.integers(0, tb.M - 1)),
                        min_size=1, max_size=16))
    def prop(pairs):
        def lift(vals):
            return RnsArray.from_parts(
                tb, np.stack([tb.residues_of(v) for v in vals]),
                np.asarray([v % tb.ma for v in vals], np.int32), device="cpu")

        a, b = lift([p for p, _ in pairs]), lift([q for _, q in pairs])
        eq(a >= b, [p >= q for p, q in pairs])
        eq(b >= a, [q >= p for p, q in pairs])

    prop()
