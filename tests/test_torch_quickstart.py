"""The port's quickstart (``repro_torch.quickstart``) on the CPU, against the
reference quickstart's steps (``examples/quickstart.py``) on the same seeds.

``main(device="cpu")`` runs every assert of its six steps; its verdicts,
quotients, remainders and scaled values must equal the reference's exactly
(tolerance: none).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference quickstart runs)
from repro.core import Layout as RLayout, RnsArray as RArray, make_base as r_make_base
from repro_torch import quickstart


def reference_steps(batch):
    """The reference quickstart's steps 1-6 on its jnp backend."""
    base = r_make_base(8, bits=15)
    rng = np.random.default_rng(0)
    N1 = int(rng.integers(0, 1 << 63)) % base.M
    N2 = int(rng.integers(0, 1 << 63)) % base.M
    ge = bool((RArray.encode(base, jnp.asarray([N1]))
               >= RArray.encode(base, jnp.asarray([N2])))[0])
    small = r_make_base(4, bits=8)
    x = RArray.encode(small, jnp.asarray([100_000, 54_321]))
    d = RArray.encode(small, jnp.asarray([317, 1000]))
    q, r = x.divmod(d)
    m = np.asarray(base.moduli_np)
    xs1 = rng.integers(0, m, size=(batch, base.n)).astype(np.int32)
    xs2 = rng.integers(0, m, size=(batch, base.n)).astype(np.int32)
    lift = lambda xs: RArray.from_parts(base, jnp.asarray(xs)).normalize(  # noqa: E731
        RLayout.BASE_MA)
    return {"ge": ge, "q": q.to_int().tolist(), "r": r.to_int().tolist(),
            "scaled": x.scale_pow2(3).to_int().tolist(),
            "verdicts": np.asarray(lift(xs1) >= lift(xs2))}


@pytest.mark.parametrize("batch", [64, 4096])
def test_quickstart_matches_reference(batch, capsys):
    got = quickstart.main(device="cpu", batch=batch)
    want = reference_steps(batch)
    assert "all correct" in capsys.readouterr().out
    for key in ("ge", "q", "r", "scaled"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["verdicts"], want["verdicts"])
    assert 0 < got["verdicts"].sum() < batch


def test_quickstart_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(verbose=False)
