"""Distribution layer: activation placement, spec trees, the RNS gradient
codec and fault detection.

Modules:
    act_sharding  logical-axis activation placement on a DeviceMesh
                  (no-ops off a mesh)
    sharding      PartitionSpec trees for params / optimizer / batch /
                  cache, and their DTensor placements
    grad_codec    exact RNS gradient all-reduce with redundant channels
                  (detect with one, locate-and-correct with two) over
                  ``torch.distributed``
    fault         tensor fingerprints + checkpoint discovery + in-place
                  RRNS buffer repair
    _tree         dict/list/tuple flattening in the reference's leaf order
"""
from .act_sharding import constrain, current_mesh, use_mesh  # noqa: F401
from .fault import (  # noqa: F401
    WireStore,
    find_restorable,
    repair_packed,
    tensor_fingerprint,
    tree_fingerprints,
    verify_fingerprints,
)
from .grad_codec import GradCodec, rns_psum, rns_psum_tree  # noqa: F401
from .sharding import (  # noqa: F401
    batch_specs,
    cache_specs,
    named_shardings,
    opt_state_specs,
    param_specs,
)
