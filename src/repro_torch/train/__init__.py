"""Training: the AdamW optimizer, with the gradient codec's decode at its
boundary (``adamw_update(grad_decode=)``)."""
from .optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
