"""Serving layer: the serving steps and cache shapes (``serve_step``), the
slot scheduler (``scheduler``), the continuous-batching engine
(``batcher.ContinuousBatcher``: slots, chunked admission prefill, one
batched decode step, RRNS fingerprints of each request's prompt KV) and the
big-integer crypto lane it can hold (``crypto``, ``batcher.CryptoEngine``).
The paged pool, the offline harness and the load generator come with a
later slice (ROADMAP.md, queue 1)."""
from .serve_step import cache_zeros, make_decode_step, make_prefill  # noqa: F401
from .scheduler import Request, Slot, SlotScheduler  # noqa: F401
from .batcher import ContinuousBatcher, CryptoEngine  # noqa: F401
from .crypto import (  # noqa: F401
    CRYPTO_OPS,
    CryptoContext,
    CryptoLane,
    CryptoRequest,
    make_crypto_fns,
)
