"""Device ms of the RRNS locate-and-correct pass a step: CUDA events
around ``train_step._repair``."""
from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, ("repair",))
