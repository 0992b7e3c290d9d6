"""Device state of the serve engine's lanes.

For now only the crypto lane's: the counterpart of the reference's
``serve_step.crypto_state_abstract``, made concrete (torch has no abstract
shapes to trace against).  The LLM lane's cache comes with the serve slice.
"""
from __future__ import annotations

import torch

__all__ = ["crypto_state_zeros"]


def crypto_state_zeros(ctx, n_slots: int, device="cuda") -> dict:
    """All-zero device state of the crypto lane: one row per slot holding
    the Montgomery-ladder registers in both bases, the per-request channel
    constants of the modulus ``N`` (per-request DATA, so one kernel serves
    every modulus mix), and the fixed-width MSB-first exponent bit row the
    ladder consumes ``chunk`` at a time.

    ``ctx`` is a ``serve.crypto.CryptoContext`` (duck-typed: only
    ``nch_lo`` / ``n`` / ``n_hi`` / ``exp_bits`` are read).

    >>> from repro_torch.serve.crypto import CryptoContext
    >>> s = crypto_state_zeros(CryptoContext(n_limbs=3, exp_bits=8), 2, "cpu")
    >>> {k: tuple(v.shape) for k, v in s.items()}["r0_lo"]
    (2, 4)
    """
    row = lambda w: torch.zeros((n_slots, w), dtype=torch.int32,
                                device=device)
    return {
        "r0_lo": row(ctx.nch_lo), "r0_hi": row(ctx.n_hi),
        "r1_lo": row(ctx.nch_lo), "r1_hi": row(ctx.n_hi),
        "neg": row(ctx.n), "n_lo": row(ctx.nch_lo), "n_hi": row(ctx.n_hi),
        "bits": row(ctx.exp_bits),
    }
