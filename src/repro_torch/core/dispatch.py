"""Backend dispatch: ONE resolver for the plain-torch-vs-CUDA-kernel decision.

    with repro_torch.core.backend("torch"):
        a >= b                    # RnsArray ops take the plain torch route

Settings:

* ``"torch"`` — always the plain torch implementations, on any device.
* ``"cuda"``  — the hand-written CUDA kernels; a CPU tensor raises.
* ``"auto"``  — the default: the kernels for a CUDA tensor, plain torch for
  a CPU tensor.

Bases with ``bits > 15`` (int64 lanes) take plain torch under every setting:
the kernels work on int32 lanes only, as the reference's Pallas gate does.

Unlike the reference, the choice depends on the operand: a torch program
holds tensors on several devices at once, so ``resolve_backend`` takes the
tensor and the base.  The setting is thread-local, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["backend", "get_backend", "resolve_backend"]

_SETTINGS = ("torch", "cuda", "auto")

_state = threading.local()


def get_backend() -> str:
    """The raw active setting: "torch" | "cuda" | "auto" (default)."""
    return getattr(_state, "setting", "auto")


def resolve_backend(t, base) -> str:
    """The route for an op on tensor ``t`` over ``base``: "torch" | "cuda".

    >>> import torch
    >>> from repro_torch.core import make_base
    >>> from repro_torch.core.dispatch import backend, resolve_backend
    >>> x = torch.zeros(2, 3, dtype=torch.int32)
    >>> resolve_backend(x, make_base(3))
    'torch'
    >>> with backend("cuda"):
    ...     resolve_backend(x, make_base(3))
    Traceback (most recent call last):
    ...
    ValueError: backend 'cuda' needs a CUDA tensor, got one on cpu
    """
    setting = get_backend()
    if setting == "torch":
        return "torch"
    on_card = t.device.type == "cuda"
    if setting == "cuda" and not on_card:
        raise ValueError(
            f"backend 'cuda' needs a CUDA tensor, got one on {t.device}"
        )
    return "cuda" if on_card and base.bits <= 15 else "torch"


@contextlib.contextmanager
def backend(setting: str):
    """Scoped backend override.

    >>> from repro_torch.core.dispatch import backend, get_backend
    >>> with backend("torch"):
    ...     get_backend()
    'torch'
    >>> get_backend()
    'auto'
    """
    if setting not in _SETTINGS:
        raise ValueError(f"backend must be one of {_SETTINGS}, got {setting!r}")
    prev = get_backend()
    _state.setting = setting
    try:
        yield
    finally:
        _state.setting = prev
