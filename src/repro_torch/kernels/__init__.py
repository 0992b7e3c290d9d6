"""Hand-written CUDA kernels for the RNS hot spots, for Hopper (sm_90a).

Kernels: mrc (Alg. 2), modmul (ring product), rns_compare (fused Alg. 1),
the gradient codec's codec_encode and codec_decode, the RRNS repair
(rrns_repair: locate and correct a faulted channel), and the dual-base
Montgomery product and ladder bit (mont_ladder), and the SSD core of the
Mamba2 models (ssd, forward and backward), each a ``.cu`` source
under ``csrc/`` with a plain torch version beside it and a public wrapper
in ops.py.  ``ref.py`` holds core-level oracles.
The kernels are built with ``nvcc`` at first use (build.py), never at import.
"""
from .ops import (  # noqa: F401
    codec_decode_op,
    codec_encode_op,
    compare_op,
    modmul_op,
    mont_ladder_op,
    mont_mul_op,
    mrc_op,
    reset_launches,
    rrns_repair_op,
    ssd_op,
)
from .ref import ref_compare, ref_modmul, ref_mrc, ref_to_ma  # noqa: F401
