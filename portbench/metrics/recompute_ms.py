"""Device ms of the remat recomputation a step: the span
``remat.recompute``, each remat unit's forward run again inside the
backward (``models.layers.remat``)."""
from portbench.span_ms import span_ms


def read(rec):
    return span_ms(rec, ("remat.recompute",))
