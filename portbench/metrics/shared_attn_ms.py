"""Device ms of the shared blocks' attention a step, inside
``shared_block_ms``: the spans ``hybrid.attn`` and ``hybrid.attn.bwd``
(``models.ssm_models._shared_attn``: projections, RoPE, the chunked
attention, the output projection).  None where the program opens no
such span."""
from portbench.span_ms import span_ms


def read(rec):
    return span_ms(rec, ("hybrid.attn", "hybrid.attn.bwd"))
