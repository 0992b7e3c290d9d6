"""RNS base definition and precomputed tables (PyTorch port).

A base ``B = {m_1..m_n}`` of pairwise-coprime moduli plus one *redundant*
modulus ``m_a`` coprime to all of them.  The tables are the reference's,
computed on the host in exact Python ints and kept as numpy arrays:

* ``inv_tri[j, i] = m_j^{-1} mod m_i`` (j < i)       — Alg. 2 (MRC)
* ``betas_ma[i]   = prod_{j<i} m_j mod m_a``         — Alg. 3 (to_ma)
* ``Mi_inv[i]     = (M/m_i)^{-1} mod m_i``           — CRT-based extensions
* Shenoy–Kumaresan and Kawamura constants            — baseline extensions

``RNSBase.tensor`` hands any of them out as a torch tensor, uploaded once per
(device, dtype) and cached on the base, so no call re-uploads a table.

Lane dtype: int32 iff ``bits <= 15`` — every product of two residues then
stays below 2**30 and no 64-bit multiply is needed.  Wider bases use int64.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["RNSBase", "gen_coprime_moduli", "is_prime", "make_base"]


_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(x: int) -> bool:
    """Deterministic Miller–Rabin, valid for x < 3.3e24 with these bases."""
    if x < 2:
        return False
    for p in _SMALL_PRIMES:
        if x % p == 0:
            return x == p
    d, s = x - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _SMALL_PRIMES:
        v = pow(a, d, x)
        if v in (1, x - 1):
            continue
        for _ in range(s - 1):
            v = v * v % x
            if v == x - 1:
                break
        else:
            return False
    return True


def gen_coprime_moduli(n: int, bits: int = 15, *, skip: int = 0) -> list[int]:
    """n largest primes strictly below 2**bits (optionally skipping some)."""
    out: list[int] = []
    x = (1 << bits) - 1
    skipped = 0
    while len(out) < n:
        if is_prime(x):
            if skipped < skip:
                skipped += 1
            else:
                out.append(x)
        x -= 2 if x % 2 else 1
        if x < 3:
            raise ValueError(f"not enough {bits}-bit primes for n={n}")
    return out


@dataclasses.dataclass(frozen=True)
class RNSBase:
    """An RNS base ``{m_1..m_n}`` with redundant modulus ``m_a``.

    Hashable on its moduli; every table is a cached numpy array, and
    ``tensor`` caches its torch copies per device.
    """

    moduli: tuple[int, ...]
    ma: int
    bits: int = 15

    def __post_init__(self):
        ms = self.moduli
        if len(set(ms)) != len(ms):
            raise ValueError("duplicate moduli")
        for i, mi in enumerate(ms):
            if math.gcd(mi, self.ma) != 1:
                raise ValueError(f"m_a={self.ma} not coprime to m_{i}={mi}")
            for mj in ms[i + 1 :]:
                if math.gcd(mi, mj) != 1:
                    raise ValueError(f"moduli {mi},{mj} not coprime")

    # -- sizes ------------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def M(self) -> int:
        """Dynamic range (Python int; may be thousands of bits)."""
        out = 1
        for m in self.moduli:
            out *= m
        return out

    @property
    def dtype(self):
        """Lane dtype (numpy): int32 iff residue products fit 31 bits."""
        return np.int32 if self.bits <= 15 else np.int64

    @property
    def tdtype(self) -> torch.dtype:
        """Lane dtype (torch), the counterpart of ``dtype``."""
        return torch.int32 if self.bits <= 15 else torch.int64

    # -- tables (numpy; exact, computed once) ------------------------------
    @functools.cached_property
    def moduli_np(self) -> np.ndarray:
        return np.asarray(self.moduli, dtype=self.dtype)

    @functools.cached_property
    def inv_tri_np(self) -> np.ndarray:
        """inv_tri[j, i] = m_j^{-1} mod m_i for j < i, else 0.  (Alg. 2)"""
        n = self.n
        t = np.zeros((n, n), dtype=self.dtype)
        for j in range(n):
            for i in range(j + 1, n):
                t[j, i] = pow(self.moduli[j], -1, self.moduli[i])
        return t

    @functools.cached_property
    def betas_ma_np(self) -> np.ndarray:
        """betas[i] = prod_{j<i} m_j mod m_a  (beta_1 = 1).  (Alg. 3)"""
        return self.betas_for((self.ma,))[0]

    def betas_for(self, targets: Sequence[int]) -> np.ndarray:
        """(T, n) partial-product table: betas[t, i] = prod_{j<i} m_j mod m_t."""
        T, n = len(targets), self.n
        out = np.zeros((T, n), dtype=np.int64)
        for t, mt in enumerate(targets):
            acc = 1
            for i in range(n):
                out[t, i] = acc % mt
                acc = (acc * self.moduli[i]) % mt
        return out.astype(self.dtype)

    @functools.cached_property
    def M_mod_ma(self) -> int:
        return self.M % self.ma

    # -- CRT-form constants (Shenoy–Kumaresan / Kawamura baselines) --------
    @functools.cached_property
    def Mi_inv_np(self) -> np.ndarray:
        """|M_i^{-1}|_{m_i} with M_i = M/m_i."""
        return np.asarray(
            [pow(self.M // m, -1, m) for m in self.moduli], dtype=self.dtype
        )

    def Mi_mod(self, targets: Sequence[int]) -> np.ndarray:
        """(T, n): M_i mod m_t."""
        out = np.zeros((len(targets), self.n), dtype=np.int64)
        for t, mt in enumerate(targets):
            for i, m in enumerate(self.moduli):
                out[t, i] = (self.M // m) % mt
        return out.astype(self.dtype)

    def M_mod(self, targets: Sequence[int]) -> np.ndarray:
        return np.asarray([self.M % mt for mt in targets], dtype=self.dtype)

    @functools.cached_property
    def inv2_np(self) -> np.ndarray:
        """2^{-1} mod m_i (all moduli odd) — used by halving/scaling."""
        return np.asarray([pow(2, -1, m) for m in self.moduli], dtype=self.dtype)

    @functools.cached_property
    def inv2_ma(self) -> int:
        return pow(2, -1, self.ma)

    def moduli_with(self, redundant: Sequence[int]) -> np.ndarray:
        """(n + k,) channel moduli: the base, then the ``redundant`` ones."""
        return np.concatenate(
            [self.moduli_np, np.asarray(redundant, dtype=self.dtype)]
        )

    # -- signed embedding -------------------------------------------------
    @functools.cached_property
    def half_M_residues(self) -> np.ndarray:
        """Residues of T = ceil(M/2): X >= T  <=>  X encodes a negative value."""
        T = (self.M + 1) // 2
        return np.asarray([T % m for m in self.moduli], dtype=self.dtype)

    @functools.cached_property
    def half_M_ma(self) -> int:
        return ((self.M + 1) // 2) % self.ma

    # -- misc ---------------------------------------------------------------
    def residues_of(self, x: int) -> np.ndarray:
        """Exact residues of a Python int (negative ok: embeds x mod M)."""
        return np.asarray([x % m for m in self.moduli], dtype=self.dtype)

    def ma_residue_of(self, x: int) -> int:
        """Residue mod m_a of the value x mod M (NOT of x itself when x<0)."""
        return (x % self.M) % self.ma

    # -- torch copies of the tables ----------------------------------------
    @functools.cached_property
    def _tensors(self) -> dict:
        return {}

    def tensor(self, table, device, dtype: torch.dtype | None = None):
        """A table as a torch tensor on ``device``, uploaded once.

        ``table`` names a table attribute (``"inv_tri_np"``) or is a
        ``(method, *args)`` tuple (``("betas_for", (ma,))``).  ``dtype``
        defaults to the lane dtype.
        """
        dtype = self.tdtype if dtype is None else dtype
        device = torch.device(device)
        key = (table, device, dtype)
        t = self._tensors.get(key)
        if t is None:
            if isinstance(table, tuple):
                arr = getattr(self, table[0])(*table[1:])
            else:
                arr = getattr(self, table)
            t = torch.from_numpy(np.array(arr, dtype=np.int64)).to(
                device=device, dtype=dtype
            )
            self._tensors[key] = t
        return t

    def __hash__(self):
        return hash((self.moduli, self.ma, self.bits))


def make_base(n: int, bits: int = 15) -> RNSBase:
    """Standard constructor: n primes just below 2**bits, plus the next prime
    down as the redundant modulus."""
    ms = gen_coprime_moduli(n + 1, bits)
    return RNSBase(moduli=tuple(ms[:n]), ma=ms[n], bits=bits)
