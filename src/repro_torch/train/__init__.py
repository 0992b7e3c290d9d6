"""Training: the AdamW optimizer with the gradient codec's decode at its
boundary (``adamw_update(grad_decode=)``), the synthetic data pipeline and
the train step, and the checkpointers: ``checkpoint`` (the legacy step
format) and ``checkpointer`` (the policy-driven async writer and the
``rrns-v1`` format with repair on restore)."""
from .optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
from .data import Prefetcher, SyntheticLM  # noqa: F401
from .train_step import make_loss_fn, make_train_step  # noqa: F401
