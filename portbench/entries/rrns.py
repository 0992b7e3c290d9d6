"""Entry ``rrns``: ``make_train_step(cfg, opt, rns_codec=..., rns_repair=
True, transport_hook=...)`` (the ``--rns-correct`` path) on a one-rank
NCCL group, with a locate-and-correct ``GradCodec`` and the benchmark's
``check.WireFaults`` planting ``faults_per_step`` seeded residue faults on
the wire each step, for the RRNS pass to locate and undo.
"""
from portbench import check, training
from portbench.reference import rrns

FAULTS = {"state_unchanged": training.state_unchanged,
          "half_batch": training.half_batch,
          "repair_skipped": training.repair_skipped}


def build(ctx):
    from repro_torch.launch.train import init_group
    from repro_torch.train.train_step import make_train_step

    init_group(ctx.device)
    tr = ctx.traffic
    hook = check.WireFaults(ctx.seed, tr["faults_per_step"],
                            rrns.channel_moduli(tr["codec"]))
    return make_train_step(training.model_config(ctx.model),
                           training.optimizer_config(tr),
                           rns_codec=training.grad_codec(tr),
                           rns_repair=True, transport_hook=hook), hook


def run(ctx):
    return training.run(ctx, build)


control = training.control
