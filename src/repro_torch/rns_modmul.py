"""Crypto-scale demo: dual-base RNS Montgomery multiplication with the
paper's comparison — the paper's own motivating context (§1, §3.1).

A ~1000-bit modular exponentiation runs entirely in RNS: products via
Montgomery multiplication (base extension = exact MRC), and the final
comparison via Algorithm 1, whose redundant modulus m_a is a modulus of the
SECOND base B' — "readily available", as the paper argues.  On a CUDA device
every product runs in the Montgomery kernel and the comparison in the fused
compare kernel.

    PYTHONPATH=src python -m repro_torch.rns_modmul            # on the card
    PYTHONPATH=src python -m repro_torch.rns_modmul --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .configs.paper_rns import make_paper_bases
from .core import RNSMontgomery, RnsArray, rns_to_int

__all__ = ["main"]


def main(device="cuda", *, verbose: bool = True) -> dict:
    """Run the demo on ``device``; returns ``got`` (X^E mod N), ``want``
    (``pow``) and ``needs_sub`` (the Algorithm-1 verdict result >= N).
    Every step asserts against the truth."""
    say = print if verbose else (lambda *a, **k: None)
    B, Bp = make_paper_bases()
    say(f"base B : n={B.n} x {B.bits}-bit moduli  (M ~ 2^{B.M.bit_length()})")
    say(f"base B': n={Bp.n} (supplies the redundant modulus m_a={B.ma})")

    rng = np.random.default_rng(0)
    # an odd ~1000-bit modulus N with M > 4N
    N = ((int(rng.integers(1, 1 << 62)) << 940)
         | int(rng.integers(1, 1 << 62)) | 1)
    mont = RNSMontgomery(B, Bp, N, device=device)

    X = int(rng.integers(0, 1 << 63)) % N
    E = 0b101101  # exponent

    # Montgomery ladder pieces: to Montgomery domain, square/multiply, back.
    R = B.M % N
    xm = mont.to_dual(X * R % N)
    acc = mont.to_dual(R)  # 1 in Montgomery domain

    t0 = time.time()
    for bit in bin(E)[2:]:
        acc = mont.mul(acc, acc)
        if bit == "1":
            acc = mont.mul(acc, xm)
    result = mont.mul(acc, mont.to_dual(1))  # leave Montgomery domain
    got = rns_to_int(B, result.xB) % N
    dt = time.time() - t0
    want = pow(X, E, N)
    assert got == want, "modular exponentiation mismatch"
    say(f"X^{E} mod N correct over {B.M.bit_length()}-bit RNS "
        f"({dt * 1e3:.0f} ms incl. host conversions)")

    # Final-normalization comparison WITHOUT leaving RNS: result < N ?
    # The Montgomery result's residues lift into the typed RnsArray; the
    # m_a channel would be carried alongside in a real pipeline (it is a
    # modulus of B', "readily available" per the paper) — here it is
    # attached with from_parts and compared with the overloaded operator.
    dev = result.xB.device
    r_arr = RnsArray.from_parts(B, result.xB, torch.tensor(got % B.ma),
                                device=dev)
    # N is ~1000 bits (beyond any tensor dtype): lift its residues exactly
    # from the host side
    n_arr = RnsArray.from_parts(B, B.residues_of(N), torch.tensor(N % B.ma),
                                device=dev)
    needs_sub = bool(r_arr >= n_arr)
    say(f"Algorithm-1 comparison (result >= N): {needs_sub} "
        f"(truth: {got >= N})")
    assert needs_sub == (got >= N)
    return {"got": got, "want": want, "needs_sub": needs_sub}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
