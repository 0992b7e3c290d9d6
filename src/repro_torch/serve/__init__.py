"""Serving layer: the serving steps and cache shapes (``serve_step``), the
slot and paged schedulers (``scheduler``), the continuous-batching engine
(``batcher.ContinuousBatcher``: slots, chunked or bucketed admission
prefill, one batched decode step, RRNS fingerprints of each request's
prompt KV; on a batched cache or a paged, prefix-sharing pool), the
big-integer crypto lane it can hold (``crypto``, ``batcher.CryptoEngine``),
and the wall-clock offline harness and closed-loop load generator on top of
it (``offline``, ``loadgen``)."""
from .serve_step import (  # noqa: F401
    cache_zeros, make_decode_step, make_prefill, paged_pool_zeros,
)
from .scheduler import (  # noqa: F401
    PageAllocator, PagedScheduler, PrefixRegistry, Request, Slot,
    SlotScheduler,
)
from .batcher import ContinuousBatcher, CryptoEngine  # noqa: F401
from .crypto import (  # noqa: F401
    CRYPTO_OPS,
    CryptoContext,
    CryptoLane,
    CryptoRequest,
    make_crypto_fns,
)
from .offline import (  # noqa: F401
    CompletionPump, OfflineInference, RankReplicaSet, ReplicaSet,
    pow2_buckets, replica_devices, replica_meshes, sample_stats,
)
from .loadgen import SLO, poisson_requests, search_max_qps  # noqa: F401
