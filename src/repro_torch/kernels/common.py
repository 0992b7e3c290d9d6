"""Plain torch versions of the kernels' shared primitives, on (n, B) tiles.

Each function repeats, op for op, what its ``__device__`` counterpart in
``csrc/common.cuh`` computes: the same f32 Barrett reduction, the same
multiply-high reduction and the same triangle.  The kernels' plain versions
(``mrc_plain``, ``modmul_plain``, ``compare_plain``, ``codec_encode_plain``,
``codec_decode_plain``) are built from these; the CPU tests hold them against the
reference's Pallas kernels and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.

Layout is **(n, B)** — channels on rows, one column per RNS number.
"""
from __future__ import annotations

import torch

__all__ = ["barrett_mod", "mod_mulhi", "recip", "mrc_rows", "to_ma_rows"]


def recip(m):
    """Correctly rounded f32 reciprocals of int moduli (``__frcp_rn``)."""
    return 1.0 / m.to(torch.float32)


def barrett_mod(t, m, r):
    """Exact t mod m for 0 <= t < m * 2**15, m < 2**15 (int32 t and m,
    f32 reciprocal r): the f32 quotient is off by at most one, and one
    correction each way makes the result exact."""
    q = torch.floor(t.to(torch.float32) * r).to(torch.int32)
    out = t - q * m
    out = torch.where(out < 0, out + m, out)
    return torch.where(out >= m, out - m, out)


def mod_mulhi(t, m):
    """Exact t mod m for int32 0 <= t < 2**31 and int32 moduli m >= 2, as
    ``csrc/common.cuh::mod_mulhi`` computes it: the quotient is the high
    word of t * floor(2**32 / m), floor(t / m) or one less, and one
    correction makes the remainder exact."""
    mu = (1 << 32) // m.to(torch.int64)
    t64 = t.to(torch.int64)
    out = t64 - ((t64 * mu) >> 32) * m
    return torch.where(out >= m, out - m, out).to(torch.int32)


def mrc_rows(w, inv, m):
    """Alg. 2 on an (n, B) int32 tile -> (n, B) mixed-radix digits.

    inv: (n, n) with inv[j, i] = m_j^{-1} mod m_i;  m: (n,) moduli.
    Step j rewrites rows j+1.. only — the triangle the kernel walks.
    """
    w = w.clone()
    m_col = m[:, None]
    r_col = recip(m_col)
    for j in range(w.shape[0] - 1):
        mi, ri = m_col[j + 1 :], r_col[j + 1 :]
        d = w[j + 1 :] - w[j]
        d = torch.where(d < 0, d + mi, d)
        w[j + 1 :] = barrett_mod(d * inv[j, j + 1 :, None], mi, ri)
    return w


def to_ma_rows(digits, betas, ma: int):
    """Alg. 3 on an (n, B) digit tile -> (B,) residues mod m_a.

    betas: (n,) partial products mod m_a.  Per-term reduction keeps the
    column sum < n * m_a < 2**31.
    """
    ma_t = torch.tensor(ma, dtype=torch.int32, device=digits.device)
    r = recip(ma_t)
    terms = barrett_mod(digits * betas[:, None], ma_t, r)
    return barrett_mod(terms.sum(dim=0, dtype=torch.int32), ma_t, r)
