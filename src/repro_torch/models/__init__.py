"""Model zoo: the configuration dataclass and the dense decoder-only family
(``transformer``), behind one dispatcher (``model``)."""
from .config import ModelConfig  # noqa: F401
from .model import (  # noqa: F401
    abstract_params,
    init_params,
    params_from_reference,
    train_logits,
)
