"""The gradient codec's moduli and a codeword check, worked out from the
paper's construction with Python integers: the n largest primes below
2**bits form the base, the next one down the redundant m_a; a
locate-and-correct codec takes the n + 2 largest, the two largest as the
redundant pair (m_a, m_b) and the rest as the base.  A value X in [0, M)
travels as X mod each channel's modulus, channels in the order base,
m_a, m_b.  Imports nothing of the program.
"""
from __future__ import annotations

import math

__all__ = ["primes_below", "codec_moduli", "channel_moduli", "column_ok"]


def _is_prime(x: int) -> bool:
    if x < 2:
        return False
    for d in range(2, math.isqrt(x) + 1):
        if x % d == 0:
            return False
    return True


def primes_below(count: int, bits: int) -> list[int]:
    """The ``count`` largest primes below 2**bits, descending."""
    out, x = [], (1 << bits) - 1
    while len(out) < count:
        if _is_prime(x):
            out.append(x)
        x -= 1
    return out


def codec_moduli(codec: dict) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(base moduli, redundant moduli) of a traffic file's ``codec``."""
    n, bits = codec["n"], codec["bits"]
    if codec["correct"]:
        ps = primes_below(n + 2, bits)
        return tuple(ps[2:]), (ps[0], ps[1])
    ps = primes_below(n + 1, bits)
    return tuple(ps[:n]), (ps[n],)


def channel_moduli(codec: dict) -> tuple[int, ...]:
    base, red = codec_moduli(codec)
    return base + red


def column_ok(column, codec: dict) -> bool:
    """Whether one wire column (a residue a channel) is a codeword: the
    base residues' CRT value X in [0, M) has X mod m_r on every redundant
    channel."""
    base, red = codec_moduli(codec)
    col = [int(v) for v in column]
    if any(not 0 <= r < mi for r, mi in zip(col, base + red)):
        return False
    M = math.prod(base)
    X = sum(r * (M // mi) * pow(M // mi, -1, mi)
            for r, mi in zip(col, base)) % M
    return all(X % mr == r for mr, r in zip(red, col[len(base):]))
