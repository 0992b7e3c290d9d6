"""Distribution layer: the RNS gradient codec and fault detection.

Modules:
    grad_codec    exact RNS gradient all-reduce with redundant channels
                  (detect with one, locate-and-correct with two) over
                  ``torch.distributed``
    fault         tensor fingerprints + checkpoint discovery + in-place
                  RRNS buffer repair
    _tree         dict/list/tuple flattening in the reference's leaf order
"""
from .fault import (  # noqa: F401
    WireStore,
    find_restorable,
    repair_packed,
    tensor_fingerprint,
    tree_fingerprints,
    verify_fingerprints,
)
from .grad_codec import GradCodec, rns_psum, rns_psum_tree  # noqa: F401
