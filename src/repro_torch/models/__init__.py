"""Model zoo: the configuration dataclass and the decoder-only families
(``transformer``: dense, moe with ``moe``'s FFN, vlm), behind one
dispatcher (``model``): init, the training forward, and the serving
functions prefill, decode and extend."""
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
