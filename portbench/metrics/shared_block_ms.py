"""Device ms of the published hybrid layout's shared blocks a step: the
spans ``hybrid.shared`` (each use's forward, from the concat to the MLP's
output: norms, attention, the MLP with its adapter) and
``hybrid.shared.bwd`` (its backward), ``models.ssm_models._shared_block``.
A remat unit's recomputation falls under ``remat.recompute``.  None where
the program opens no such span."""
from portbench.span_ms import span_ms


def read(rec):
    return span_ms(rec, ("hybrid.shared", "hybrid.shared.bwd"))
