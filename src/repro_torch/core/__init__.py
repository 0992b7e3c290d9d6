"""Core RNS library — the paper's contribution as composable torch modules.

The typed frontend is ``RnsArray`` (+ the ``backend`` context manager for
the plain-torch-vs-CUDA-kernel dispatch); the loose functions below it are
the implementations it routes through.
"""
from .array import Layout, RnsArray  # noqa: F401
from .dispatch import backend, get_backend, resolve_backend  # noqa: F401
from .base import RNSBase, gen_coprime_moduli, make_base  # noqa: F401
from .arith import add, sub, mul, neg, mul_const  # noqa: F401
from .mrc import mrc, mrc_unrolled, mrs_ge, mrs_to_int  # noqa: F401
from .mrc_tree import mrc_tree  # noqa: F401
from .convert import (  # noqa: F401
    to_ma,
    mrs_dot_mod,
    int_to_rns,
    rns_to_int,
    tensor_to_rns,
    rns_to_tensor,
)
from .compare import (  # noqa: F401
    rns_compare_ge,
    classic_compare_ge,
    approx_crt_ge,
    compare_packed_ge,
)
from .extend import extend_mrc, extend_shenoy, extend_kawamura  # noqa: F401
from .signed import encode_signed, is_negative, abs_ge_threshold  # noqa: F401
from .division import (  # noqa: F401
    pack,
    unpack,
    divmod_rns,
    halve,
    scale_pow2,
    parity,
)
from .montgomery import (  # noqa: F401
    RNSMontgomery,
    DualRep,
    mont_mul,
    ladder_step,
    ladder_steps,
    mont_consts,
)
