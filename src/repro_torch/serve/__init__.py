"""Serving layer.  For now the crypto lane — the serve engine's second
request family: ``crypto`` (requests, context, slot scheduler and device
functions), ``serve_step`` (its device state) and ``batcher.CryptoEngine``
(admission, ladder ticks, retirement and the RRNS wire fingerprints).  The
LLM lane and the ``ContinuousBatcher`` that holds both come with the serve
slice."""
from .batcher import CryptoEngine  # noqa: F401
from .crypto import (  # noqa: F401
    CRYPTO_OPS,
    CryptoContext,
    CryptoLane,
    CryptoRequest,
    make_crypto_fns,
)
