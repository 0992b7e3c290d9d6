"""Entry ``plain``: ``repro_torch.train.train_step.make_train_step(cfg,
opt)``, the default training step, no gradient codec.

An entry file gives ``run(ctx) -> dict`` (one run, see ``harness``),
``control(ctx) -> numbers`` and ``FAULTS`` (name -> a ``wrap_step`` that
breaks the timed path), found by a traffic mix's ``entry``.
"""
from portbench import training

FAULTS = {"state_unchanged": training.state_unchanged,
          "half_batch": training.half_batch}


def build(ctx):
    from repro_torch.train.train_step import make_train_step

    return make_train_step(training.model_config(ctx.model),
                           training.optimizer_config(ctx.traffic)), None


def run(ctx):
    return training.run(ctx, build)


control = training.control
