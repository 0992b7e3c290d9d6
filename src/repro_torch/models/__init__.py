"""Model zoo: the configuration dataclass and the six families — the
decoder-only ones and the encoder-decoder (``transformer``: dense, moe
with ``moe``'s FFN, vlm, encdec) and the state-space ones (``ssm_models``
over ``ssm``'s Mamba2 block: ssm, hybrid) — behind one dispatcher
(``model``): init, the training forward, and the serving functions
prefill, decode and extend."""
from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    abstract_params,
    decode_step,
    extend_step,
    init_params,
    params_from_reference,
    prefill,
    train_logits,
)
