"""The yardstick's arithmetic: the card's peaks, the bytes a codec kernel
must move and the model FLOPs of a training step, all from the shapes in a
configuration file.  What later implements the work does not change these
counts.  A family's own sums (``matrix_params_applied``,
``seq_flops_per_token``) are in ``portbench/families/<family>.py``, built
from the per-layer counts here.
"""
from __future__ import annotations

import math

__all__ = ["PEAKS", "grad_elements", "encode_bytes", "decode_bytes",
           "mamba_matrix_params", "ssd_flops_per_token",
           "model_flops_per_step"]

# NVIDIA H100 SXM5 80GB, the data sheet's dense rates at 700 W: bf16 tensor
# cores and HBM3 bandwidth.
PEAKS = {"card": "NVIDIA H100 SXM5 80GB (data sheet)",
         "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def grad_elements(family, m) -> int:
    """Elements of the gradient tree: one f32 wire column each."""
    return sum(math.prod(s) for _, s, _ in family.param_spec(m))


def encode_bytes(elements: int, channels: int) -> int:
    """An encode reads each f32 gradient once and writes one int32 residue
    a channel: 4 + 4c bytes an element."""
    return elements * (4 + 4 * channels)


def decode_bytes(elements: int, base_channels: int) -> int:
    """A decode reads the base channels' int32 sums (the redundant ones
    play no part in the value) and writes one f32: 4b + 4 bytes an
    element."""
    return elements * (4 * base_channels + 4)


def mamba_matrix_params(m) -> int:
    """The matrix parameters of one Mamba2 layer: in_proj and out_proj."""
    d, d_in = m["d_model"], m["ssm_expand"] * m["d_model"]
    h, ds = d_in // m["ssm_headdim"], m["ssm_state"]
    return d * (2 * d_in + 2 * ds + h) + d_in * d


def ssd_flops_per_token(m, seq: int) -> float:
    """Forward FLOPs of one layer's SSD a token, at chunk Q = min(chunk,
    seq), heads h of p, state n (one group):
    within a chunk the causal half of C.B^T (2 Q n / 2) and of the weighted
    sum over x (2 Q h p / 2); the chunk state B^T x (2 n h p) and the
    output from the earlier chunks' state C.S (2 n h p)."""
    d_in = m["ssm_expand"] * m["d_model"]
    hp, n = d_in, m["ssm_state"]
    Q = min(m["ssm_chunk"], seq)
    return Q * (n + hp) + 4.0 * n * hp


def model_flops_per_step(family, m, batch: int, seq: int) -> float:
    """Model FLOPs of one training step, forward and backward (3x the
    forward), recomputation left out: 6 T P + 3 T S, with T = batch x seq
    tokens, P the matrix parameters applied to a token
    (``family.matrix_params_applied``) and S the forward FLOPs a token of
    the sequence mixing that no parameter counts
    (``family.seq_flops_per_token``: the SSD's, attention's)."""
    tokens = batch * seq
    return (6.0 * tokens * family.matrix_params_applied(m)
            + 3.0 * tokens * family.seq_flops_per_token(m, seq))
