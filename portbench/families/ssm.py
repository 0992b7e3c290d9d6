"""Family ``ssm``: a stack of Mamba2 layers (arXiv:2405.21060), the tied
embedding before it and a final norm after: the port's ``ssm_models``
stack, whose layer leaves are stacked over the layers under ``layers``.

A family file gives what the benchmark needs of a model family, found by
the ``family`` of a configuration's ``model`` block:

* ``param_spec(m)``: the parameter layout, ``[(path, shape, draw)]``
  (``inputs.init_params`` draws it);
* ``STACKED``: the leading axes a top-level leaf is stacked over, so that
  ``check`` compares each layer's slice on its own;
* ``logits(params, m, tokens, mm)``: the reference forward, plain PyTorch
  from the paper, every product through ``mm``;
* ``matrix_params_applied(m)``, ``seq_flops_per_token(m, seq)``: what
  ``counts.model_flops_per_step`` sums.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from portbench import counts
from portbench.inputs import mamba_leaves
from portbench.reference import model as blocks

STACKED = {"layers": 1}


def param_spec(m):
    d = m["d_model"]
    return ([(("embed",), (m["vocab"], d), "n0.02"),
             (("final_norm",), (d,), "zeros")]
            + [(("layers",) + p, s, k)
               for p, s, k in mamba_leaves(m, (m["n_layers"],))])


def logits(params, m, tokens, mm):
    """(b, s) tokens -> (b, s, V) logits, the embedding tied."""
    E = params["embed"]
    x = F.embedding(tokens, E) * math.sqrt(m["d_model"])
    for i in range(m["n_layers"]):
        x = blocks.recomputed(blocks.mamba_layer,
                              blocks.layer(params["layers"], (i,)), m, x, mm)
    x = blocks.rms_norm(x, params["final_norm"], m["norm_eps"])
    return mm(x, E.T)


def matrix_params_applied(m) -> int:
    """Every layer's two projections and the tied unembedding (the
    embedding lookup does no products)."""
    return (m["n_layers"] * counts.mamba_matrix_params(m)
            + m["vocab"] * m["d_model"])


def seq_flops_per_token(m, seq: int) -> float:
    return m["n_layers"] * counts.ssd_flops_per_token(m, seq)
