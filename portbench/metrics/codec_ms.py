"""Device ms of the gradient codec a step: CUDA events around
``tree_pack_rns`` (flatten + encode), the wire's ``psum`` and
``tree_decode``."""
from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, ("pack", "wire_psum", "decode"))
