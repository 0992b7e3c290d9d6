"""The paper's own configuration: crypto-grade RNS bases for the comparison
workload.

n=137 15-bit moduli gives a ~2048-bit dynamic range (RSA/FHE scale);
the redundant modulus m_a is drawn from the second base B' per §3.1.
"""
from ..core import RNSBase, gen_coprime_moduli

N_CHANNELS = 137          # ~2048-bit dynamic range with 15-bit moduli
BITS = 15


def make_paper_bases():
    """(B, B') with m_a = first modulus of B' — the paper's §3.1 setup."""
    ms = gen_coprime_moduli(2 * N_CHANNELS + 1, BITS)
    B = RNSBase(moduli=tuple(ms[:N_CHANNELS]), ma=ms[2 * N_CHANNELS], bits=BITS)
    Bp = RNSBase(
        moduli=tuple(ms[N_CHANNELS : 2 * N_CHANNELS]), ma=ms[0], bits=BITS
    )
    return B, Bp
