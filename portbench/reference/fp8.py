"""The control: the reference's products in fp8, the precision below the
configurations' bf16 compute.  Each product's operands round to
float8_e4m3fn and the incoming gradient of its backward to float8_e5m2,
each tensor scaled by its own absolute maximum first (per-tensor scaling,
as fp8 training does); the products then run in the operands' dtype.
"""
from __future__ import annotations

import torch

__all__ = ["fp8_mm", "round_fp8"]


def round_fp8(t, dtype):
    """``t`` rounded to ``dtype`` after scaling its largest magnitude to the
    format's largest finite value, and scaled back."""
    fmax = torch.finfo(dtype).max
    scale = fmax / t.detach().abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = round_fp8(a, torch.float8_e4m3fn)
        bq = round_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = round_fp8(g, torch.float8_e5m2)
        ga = gq @ bq.transpose(-1, -2)
        gb = aq.transpose(-1, -2) @ gq
        # a 2-D weight against batched activations: sum the leading axes
        while gb.ndim > bq.ndim:
            gb = gb.sum(0)
        return ga, gb


def fp8_mm(a, b):
    """``a @ b`` with fp8 operands and an fp8 incoming gradient."""
    return _Fp8Matmul.apply(a, b)
