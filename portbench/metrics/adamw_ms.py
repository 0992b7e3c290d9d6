"""Device ms of AdamW a step: CUDA events around ``adamw_update``, less
the ``tree_decode`` it runs at the optimizer boundary on a codec step."""
from portbench.readers import stage_mean


def read(rec):
    return stage_mean(rec, ("adamw",), sub=("decode",))
