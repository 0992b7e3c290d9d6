"""repro_torch — the RNS-comparison framework (Didier et al.) on PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``repro``, module for module: ``core`` (bases,
Algorithms 1–3, the ``RnsArray`` frontend and backend dispatch), ``kernels``
(the MRC, modmul and fused-compare kernels with their plain torch versions)
and ``configs``.  It imports no JAX and nothing of ``repro``.
"""
