"""Device ms of the SSD core a step: the spans ``ssm.ssd`` (each layer's
forward) and ``ssm.ssd.bwd`` (its backward), ``models.ssm.ssd`` on both
paths.  A remat unit's recomputation of the SSD falls under
``remat.recompute`` (``recompute_ms``), which opens no span inside it."""
from portbench.span_ms import span_ms


def read(rec):
    return span_ms(rec, ("ssm.ssd", "ssm.ssd.bwd"))
