"""repro_torch — the RNS-comparison framework (Didier et al.) on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``repro``, module for module: ``core`` (bases,
Algorithms 1–3, the ``RnsArray`` frontend and backend dispatch, dual-base
Montgomery arithmetic), ``kernels`` (the hand-written CUDA kernels with
their plain torch versions), ``dist`` (the exact gradient all-reduce and
fault repair), ``train`` (AdamW), ``serve`` and ``launch`` (the crypto lane
of the serve engine and its CLI) and ``configs``.  It imports no JAX and
nothing of ``repro``.
"""
