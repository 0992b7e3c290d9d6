"""Family ``hybrid``: Zamba2's published hybrid stack (arXiv:2411.15242),
the port's ``ssm_models`` with ``hybrid_layer_ids`` set: Mamba2 layers
with B and C in ``ssm_groups`` groups, stacked under ``layers``; before
the Mamba2 layer of each hybrid layer, one of ``n_mem_blocks`` shared
attention+MLP blocks (stacked under ``blocks``) over concat(hidden,
embedding), with the hybrid layer's own MLP adapter and d x d linear
(stacked under ``hybrid``).  The reference is ``reference/zamba2.py``;
what a family file gives is said in ``families/ssm.py``.
"""
from __future__ import annotations

from portbench.reference import zamba2

STACKED = {"layers": 1, "hybrid": 1, "blocks": 1}


def _dims(m):
    d_in = m["ssm_expand"] * m["d_model"]
    return d_in, d_in // m["ssm_headdim"], m["ssm_state"], m["ssm_groups"]


def _mamba_leaves(m, lead):
    """One Mamba2 layer's leaves with G groups of B and C, stacked over
    ``lead``: the draws of ``inputs.mamba_leaves``."""
    d = m["d_model"]
    d_in, h, ds, G = _dims(m)
    conv_ch = d_in + 2 * G * ds
    return [
        (("ln",), lead + (d,), "zeros"),
        (("mamba", "in_proj"), lead + (d, d_in + conv_ch + h), "n0.02"),
        (("mamba", "conv_w"), lead + (m["ssm_conv"], conv_ch), "n0.1"),
        (("mamba", "conv_b"), lead + (conv_ch,), "zeros"),
        (("mamba", "A_log"), lead + (h,), "a_log"),
        (("mamba", "D"), lead + (h,), "ones"),
        (("mamba", "dt_bias"), lead + (h,), "dt_bias"),
        (("mamba", "norm"), lead + (d_in,), "zeros"),
        (("mamba", "out_proj"), lead + (d_in, d), "n0.02"),
    ]


def param_spec(m):
    d, ff, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    heads, kv, hd = m["n_heads"], m["n_kv"], m["head_dim"]
    H, nb = len(m["hybrid_layer_ids"]), m["n_mem_blocks"]
    return ([(("embed",), (m["vocab"], d), "n0.02"),
             (("final_norm",), (d,), "zeros")]
            + [(("layers",) + p, s, k)
               for p, s, k in _mamba_leaves(m, (m["n_layers"],))]
            + [(("hybrid", "adapter_a"), (H, d, r), "n0.02"),
               (("hybrid", "adapter_b"), (H, r, 2 * ff), "n0.02"),
               (("hybrid", "linear"), (H, d, d), "n0.02"),
               (("blocks", "ln1"), (nb, 2 * d), "zeros"),
               (("blocks", "attn", "wq"), (nb, 2 * d, heads, hd), "n0.02"),
               (("blocks", "attn", "wk"), (nb, 2 * d, kv, hd), "n0.02"),
               (("blocks", "attn", "wv"), (nb, 2 * d, kv, hd), "n0.02"),
               (("blocks", "attn", "wo"), (nb, heads, hd, d), "n0.02"),
               (("blocks", "ln2"), (nb, d), "zeros"),
               (("blocks", "mlp", "wi"), (nb, d, 2, ff), "n0.02"),
               (("blocks", "mlp", "wo"), (nb, ff, d), "n0.02")])


logits = zamba2.logits


def _mamba_matrix_params(m) -> int:
    """A Mamba2 layer's in_proj and out_proj, G groups of B and C."""
    d = m["d_model"]
    d_in, h, ds, G = _dims(m)
    return d * (2 * d_in + 2 * G * ds + h) + d_in * d


def _hybrid_matrix_params(m) -> int:
    """One use of a shared block (q, k, v from 2 d, o back to d, the
    gated MLP), the layer's adapter and its linear."""
    d, ff, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    hd = m["head_dim"]
    attn = 2 * d * (m["n_heads"] + 2 * m["n_kv"]) * hd + m["n_heads"] * hd * d
    return attn + 3 * d * ff + r * (d + 2 * ff) + d * d


def matrix_params_applied(m) -> int:
    """Every layer's Mamba2 projections, each hybrid layer's use of its
    shared block with its adapter and linear, and the tied unembedding
    (the embedding lookup does no products)."""
    return (m["n_layers"] * _mamba_matrix_params(m)
            + len(m["hybrid_layer_ids"]) * _hybrid_matrix_params(m)
            + m["vocab"] * m["d_model"])


def seq_flops_per_token(m, seq: int) -> float:
    """Each layer's SSD (``counts.ssd_flops_per_token`` with C.B^T taken
    once a group, 2 Q n G / 2 a token) and each hybrid layer's causal
    attention: q k^T and p v over the causal half of the row, 2 x 2 x
    seq / 2 x heads x hd a token."""
    d_in, _, n, G = _dims(m)
    Q = min(m["ssm_chunk"], seq)
    ssd = Q * (G * n + d_in) + 4.0 * n * d_in
    attn = 2.0 * seq * m["n_heads"] * m["head_dim"]
    return m["n_layers"] * ssd + len(m["hybrid_layer_ids"]) * attn
