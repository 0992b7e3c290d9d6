"""Device ms of the model's forward and backward a step: CUDA events
around ``train_step.value_and_grad``."""
from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, ("fwd_bwd",))
