"""Entry ``rns``: ``repro_torch.launch.train.make_rns_dp_step`` (the
``--rns-allreduce`` path) on a one-rank NCCL group made as
``launch.train.init_group`` makes it, with the traffic's ``GradCodec``:
the gradient tree encoded into residues, summed over the group, decoded.
"""
from portbench import training

FAULTS = {"state_unchanged": training.state_unchanged,
          "half_batch": training.half_batch}


def build(ctx):
    from repro_torch.launch.train import init_group, make_rns_dp_step

    init_group(ctx.device)
    return make_rns_dp_step(training.model_config(ctx.model),
                            training.optimizer_config(ctx.traffic),
                            training.grad_codec(ctx.traffic))[0], None


def run(ctx):
    return training.run(ctx, build)


control = training.control
