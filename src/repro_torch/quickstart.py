"""Quickstart: the paper's RNS comparison in six steps — typed API.

Everything goes through ``RnsArray``: ONE type carrying residues + the
redundant m_a channel, with the paper's algorithms as methods and
operators.  On a CUDA device every Algorithm-1/2 call and ring product runs
in the hand-written kernels; on the CPU the same calls take plain torch.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import Layout, RnsArray, backend, classic_compare_ge, make_base, rns_to_int

__all__ = ["main"]


def main(device="cuda", *, batch: int = 4096, verbose: bool = True) -> dict:
    """Run the six steps on ``device`` and return what they computed:
    ``ge`` (step 3), ``q``/``r``/``scaled`` (step 5) and ``verdicts``
    (step 6, a numpy bool array).  Every step asserts against the truth."""
    say = print if verbose else (lambda *a, **k: None)

    # 1. An RNS base: 8 15-bit prime moduli + a redundant modulus m_a.
    base = make_base(8, bits=15)
    say(f"base: n={base.n} moduli, dynamic range M ~ 2^{base.M.bit_length()}, "
        f"m_a={base.ma}")

    # 2. Lift two big integers into the representation.  ``encode`` computes
    #    the residue channels AND the consistent redundant m_a channel.
    rng = np.random.default_rng(0)
    N1 = int(rng.integers(0, 1 << 63)) % base.M
    N2 = int(rng.integers(0, 1 << 63)) % base.M
    a = RnsArray.encode(base, [N1], device=device)
    b = RnsArray.encode(base, [N2], device=device)
    say(f"layout={a.layout.name}, channels={a.n_channels} "
        f"(n base + m_a riding along)")

    # 3. Compare with ONE mixed-radix conversion (Algorithm 1 / Theorem 1).
    ge = bool((a >= b)[0])
    say(f"N1 >= N2?  RNSComp says {ge}, truth is {N1 >= N2}")
    assert ge == (N1 >= N2)

    # 4. The classical method needs TWO conversions (the paper's baseline).
    assert bool(classic_compare_ge(base, a.x, b.x)[0]) == (N1 >= N2)

    # 5. Arithmetic stays exact and in-representation; division and scaling
    #    are comparison-driven (the operations the paper's conclusion unlocks).
    small = make_base(4, bits=8)
    x = RnsArray.encode(small, [100_000, 54_321], device=device)
    d = RnsArray.encode(small, [317, 1000], device=device)
    q, r = x.divmod(d)
    q, r = q.to_int().tolist(), r.to_int().tolist()
    assert q == [100_000 // 317, 54]
    assert r == [100_000 % 317, 321]
    say(f"divmod in pure RNS: 100000 = {q[0]}*317 + {r[0]}")
    scaled = x.scale_pow2(3).to_int().tolist()
    assert scaled == [100_000 // 8, 54_321 // 8]

    # 6. Batched: the SAME call sites at batch scale — the fused compare
    #    kernel on the card — held against the host big-int oracle and
    #    against the plain torch route on a host copy.
    m = np.asarray(base.moduli_np)
    xs1 = rng.integers(0, m, size=(batch, base.n)).astype(np.int32)
    xs2 = rng.integers(0, m, size=(batch, base.n)).astype(np.int32)

    def lift(xs):  # BASE -> BASE_MA: compute the m_a channel
        return RnsArray.from_parts(base, xs, device=device).normalize(
            Layout.BASE_MA)

    A, B = lift(xs1), lift(xs2)
    verdicts = (A >= B).cpu().numpy()
    vals1 = [rns_to_int(base, row) for row in xs1]
    vals2 = [rns_to_int(base, row) for row in xs2]
    truth = np.asarray([v1 >= v2 for v1, v2 in zip(vals1, vals2)])
    assert (verdicts == truth).all()
    with backend("torch"):
        plain = (A.to("cpu") >= B.to("cpu")).numpy()
    assert (verdicts == plain).all()
    say(f"{batch} comparisons on {torch.device(device)}: all correct and "
        f"bitwise-identical to the plain torch route")
    return {"ge": ge, "q": q, "r": r, "scaled": scaled, "verdicts": verdicts}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args()
    main(args.device, batch=args.batch)
