"""Partition specs for parameters, optimizer state, batches and caches, and
their placements on a ``torch.distributed.device_mesh.DeviceMesh`` — the
reference's ``repro/dist/sharding.py`` rule for rule.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor axis,
``None`` (replicated), a mesh-axis name, or a tuple of names (one tensor
axis split over several mesh axes, major to minor).  The spec trees have
the structure of the tree they describe and ``PartitionSpec`` leaves.

``param_specs`` applies ``_rule`` per leaf.  Rules use NEGATIVE axis
indices against the leaf's CANONICAL (unstacked) rank, so the leading
layer/group stack dims are never sharded:

    attn  wq/wk/wv (..., d, h, hd)   -> heads at -2
    attn  wo       (..., h, hd, d)   -> heads at -3
    mlp   wi       (..., d, 2, ff)   -> ff    at -1
    mlp   wo       (..., ff, d)      -> ff    at -2
    moe   wi       (..., E, d, 2, f) -> E at -4, else expert-ff at -1
    moe   wo       (..., E, f, d)    -> E at -3, else expert-ff at -2
    embed          (V, d)            -> vocab at -2 (vocab is padded to 128)
    mamba in_proj / out_proj         -> column / row parallel

Every assignment is guarded by divisibility against the model-axis size.
ZeRO-1 optimizer specs also shard the first still-replicated divisible
axis over the data axes (``opt_state_specs``).

The spec functions read only the mesh's axis names and sizes, so a stand-in
with ``.shape`` (a name -> size mapping) and ``.axis_names`` drives them as
well as a ``DeviceMesh`` (``mesh_dim_names`` and its shape).
``named_shardings`` maps specs to ``NamedSharding``s, the ``(mesh,
placements)`` pairs ``DTensor`` takes: each mesh dimension is ``Shard(i)``
for the tensor axis ``i`` that names it, and ``Replicate()`` otherwise.
"""
from __future__ import annotations

import dataclasses
import math

from . import _tree

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs",
    "named_shardings",
    "mesh_axes",
    "mesh_device",
    "local_slices",
    "place_host",
]

_ATTN_PARENTS = ("attn", "self_attn", "cross_attn")


class PartitionSpec(tuple):
    """One entry per tensor axis: None, a mesh-axis name or a tuple of
    names.  A leaf of the spec trees (``_tree`` does not descend into it)."""

    _tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of any
    object with the reference mesh's ``.shape`` mapping and
    ``.axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    sizes = dict(mesh.shape)
    return {a: sizes[a] for a in mesh.axis_names}


def _data_axes(names) -> tuple:
    return tuple(a for a in ("pod", "data") if a in names)


def _shape(leaf) -> tuple:
    """A leaf's shape; a host scalar (a cache's ``len``) is rank 0."""
    return tuple(getattr(leaf, "shape", ()))


# ----------------------------------------------------------------- rules
def _rule(name, shape, model: int, *, parent=None, n_experts: int = 0):
    """Sharding rule for one leaf: list of mesh-axis names (len == rank)."""
    spec = [None] * len(shape)
    rank = len(shape)

    def shard(ax: int):
        """Shard negative axis ``ax`` over 'model' when valid & divisible."""
        if -ax <= rank and model > 1 and shape[ax] % model == 0:
            spec[rank + ax] = "model"

    if n_experts and name in ("wi", "wo"):
        # MoE expert weights: canonical wi (E, d, 2, f) / wo (E, f, d).
        e_ax = -4 if name == "wi" else -3
        if -e_ax <= rank and shape[e_ax] == n_experts and n_experts % model == 0:
            shard(e_ax)
        else:  # experts indivisible (qwen 60) -> shard the expert-ff dim
            shard(-1 if name == "wi" else -2)
        return spec
    if parent in _ATTN_PARENTS:
        if name in ("wq", "wk", "wv"):
            shard(-2)
        elif name == "wo":
            shard(-3)
        return spec
    if parent == "mlp":
        if name == "wi":
            shard(-1)
        elif name == "wo":
            shard(-2)
        return spec
    if parent == "mamba":
        if name == "in_proj":
            shard(-1)  # column-parallel over the packed zxBCdt projection
        elif name == "out_proj":
            shard(-2)  # row-parallel over d_inner
        return spec
    if name == "embed":
        shard(-2)  # vocab axis; padded to a multiple of 128
        return spec
    if name == "router":
        shard(-1)
        return spec
    return spec  # norms, biases, scalars: replicated


def _parent_of(keys) -> str | None:
    for k in reversed(keys[:-1]):
        if k in _ATTN_PARENTS:
            return "attn"
        if k in ("mlp", "moe", "mamba"):
            return k
    return None


def _map_named(fn, tree):
    """``fn(keys, leaf)`` over a tree's leaves, rebuilt in its structure;
    ``keys`` are the path's dict keys and ``[i]`` positions."""
    named = _tree.flatten_named(tree)
    spec = _tree.flatten(tree)[1]
    return _tree.unflatten(
        spec, [fn(name.split("/") if name else [], leaf)
               for name, leaf in named])


def param_specs(params_abs, mesh, *, n_experts: int = 0):
    """PartitionSpec tree matching ``params_abs`` for ``mesh``."""
    model = mesh_axes(mesh).get("model", 1)

    def leaf_spec(keys, leaf):
        name, parent = keys[-1], _parent_of(keys)
        shape = _shape(leaf)
        if parent == "moe":
            # shared experts are dense mlp weights living under the moe dict
            if name in ("shared_wi", "shared_wo"):
                return P(*_rule("w" + name[-1], shape, model, parent="mlp"))
            ne = n_experts if name in ("wi", "wo") else 0
            return P(*_rule(name, shape, model, n_experts=ne))
        return P(*_rule(name, shape, model, parent=parent))

    return _map_named(leaf_spec, params_abs)


# -------------------------------------------------------------- optimizer
def opt_state_specs(params_abs, pspecs, mesh, *, zero1: bool = True):
    """Specs for per-parameter optimizer tensors (m/v/f32 masters).

    With ``zero1`` the first axis that is still replicated in the parameter
    spec and divides the data-axis product additionally shards over the data
    axes — ZeRO-1 state partitioning on top of tensor parallelism.
    """
    sizes = mesh_axes(mesh)
    data_axes = _data_axes(sizes)
    dsize = math.prod(sizes[a] for a in data_axes) if data_axes else 1

    def z(leaf, spec):
        if not zero1 or dsize <= 1:
            return spec
        shape = _shape(leaf)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, e in enumerate(entries):
            if e is None and shape[i] % dsize == 0 and shape[i] > 0:
                entries[i] = data_axes[0] if len(data_axes) == 1 else data_axes
                break
        return P(*entries)

    return _tree.tree_map(z, params_abs, pspecs)


# ------------------------------------------------------------------ batch
def batch_specs(batch_abs, mesh):
    """Shard the leading (global-batch) axis of every leaf over the data
    axes, dropping axes from the minor end until the product divides."""
    sizes = mesh_axes(mesh)
    data_axes = _data_axes(sizes)

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        axes = data_axes
        while axes and shape[0] % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
        if not axes:
            return P(*([None] * len(shape)))
        first = axes[0] if len(axes) == 1 else axes
        return P(first, *([None] * (len(shape) - 1)))

    return _tree.tree_map(spec, batch_abs)


# ------------------------------------------------------------------ cache
# canonical (unstacked) rank and (batch_axis, model_axis) per cache leaf name;
# model_axis None = never tensor-sharded.  Leading extra dims are layer /
# group stacks and stay unsharded.
_CACHE_RULES = {
    "k": (4, 0, 2),     # (b, S, g, hd): batch at 0, kv heads at 2
    "v": (4, 0, 2),
    "gk": (4, 0, 2),
    "gv": (4, 0, 2),
    "lk": (4, 0, 2),
    "lv": (4, 0, 2),
    "ks": (2, 0, 1),    # int8 dequant scales (b, g)
    "vs": (2, 0, 1),
    "enc": (3, 0, None),  # encoder states (b, F, d)
    "S": (4, 0, None),    # SSM state (b, h, ds, p)
    "conv": (3, 0, None),  # conv ring (b, W, c)
}


def cache_specs(cache_abs, mesh, *, paged_pool: bool = False):
    """PartitionSpec tree for a decode cache: batch over data, KV heads over
    model when divisible; scan-stack dims and scalars replicated.

    ``paged_pool=True`` reads the k/v leaves as the PAGED pool layout
    (L, n_pages, page_size, g, hd): the page pool stands in for the batch
    axis and the within-page axis for the sequence axis.  The rules carry
    over except the GQA fallback: within-page offsets are too small to
    shard, so indivisible KV heads fall back on the page-POOL axis.
    """
    sizes = mesh_axes(mesh)
    data_axes = _data_axes(sizes)
    dsize = math.prod(sizes[a] for a in data_axes) if data_axes else 1
    model = sizes.get("model", 1)

    def spec(keys, leaf):
        name = keys[-1] if keys else ""
        shape = _shape(leaf)
        rank = len(shape)
        rule = _CACHE_RULES.get(name)
        if rule is None or rank < rule[0]:
            return P(*([None] * rank))
        canon, b_ax, m_ax = rule
        extra = rank - canon
        entries = [None] * rank
        if dsize > 1 and shape[extra + b_ax] % dsize == 0:
            entries[extra + b_ax] = (
                data_axes[0] if len(data_axes) == 1 else data_axes
            )
        if m_ax is not None and model > 1:
            if shape[extra + m_ax] % model == 0:
                entries[extra + m_ax] = "model"
            elif canon == 4 and paged_pool:
                # paged-pool GQA fallback: pages are interchangeable, so
                # spread the page-pool axis over "model" (stacking on top
                # of any data-axis assignment when the divisibility holds)
                cur = entries[extra + b_ax]
                if cur is None:
                    if shape[extra + b_ax] % model == 0:
                        entries[extra + b_ax] = "model"
                elif shape[extra + b_ax] % (dsize * model) == 0:
                    prev = cur if isinstance(cur, tuple) else (cur,)
                    entries[extra + b_ax] = prev + ("model",)
            elif canon == 4 and shape[extra + 1] % model == 0:
                # KV heads do not divide the model axis (GQA with few KV
                # heads): shard the SEQUENCE axis of the (b, S, g, hd)
                # cache instead of replicating it over the model axis
                entries[extra + 1] = "model"
        return P(*entries)

    return _map_named(spec, cache_abs)


# ------------------------------------------------------------- placements
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec resolved on a ``DeviceMesh``: ``placements`` has one
    ``Shard``/``Replicate`` per mesh dimension, as ``DTensor`` takes it."""

    mesh: object
    spec: PartitionSpec
    placements: tuple


def _placements(spec, mesh) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh_axes(mesh))
    owner = {}
    for i, entry in enumerate(spec):
        group = (entry,) if isinstance(entry, str) else tuple(entry or ())
        pos = [names.index(a) for a in group]
        if pos != sorted(pos):
            raise ValueError(f"{spec}: axes {group} are not in the mesh's "
                             f"major-to-minor order {names}")
        for a in group:
            if a in owner:
                raise ValueError(f"{spec}: mesh axis {a!r} named twice")
            owner[a] = i
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


def mesh_device(mesh):
    """The device this rank's shards live on: the current card of a CUDA
    mesh, else the mesh's device type."""
    import torch

    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_slices(shape, mesh, placements) -> tuple:
    """This rank's index ranges of a tensor of global ``shape``, one
    ``slice`` per axis, as DTensor cuts a ``Shard``: ``torch.chunk``'s
    ceil-sized pieces along the axis, a mesh dimension at a time in mesh
    order (so the first of several dimensions on one axis is the major
    one)."""
    bounds = [[0, n] for n in shape]
    coord = mesh.get_coordinate()
    for dim, p in enumerate(placements):
        if not p.is_shard():
            continue
        lo, hi = bounds[p.dim]
        size = -(-(hi - lo) // mesh.size(dim))
        start = min(hi, lo + coord[dim] * size)
        bounds[p.dim] = [start, min(hi, start + size)]
    return tuple(slice(lo, hi) for lo, hi in bounds)


def place_host(t, sharding):
    """A whole tensor, on the host or on the mesh's device, as a DTensor
    placed by ``sharding``: this rank's slice is taken, moved to the mesh's
    device (no copy when it is already there and whole) and wrapped with
    ``DTensor.from_local``, so a host tensor never lands whole on a rank's
    device.  A ``meta`` tensor stays on ``meta`` (the dry run's shapes)."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements
    local = t[local_slices(tuple(t.shape), mesh, placements)].contiguous()
    if t.device.type != "meta":
        local = local.to(mesh_device(mesh))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def named_shardings(specs, mesh):
    """Map a tree of PartitionSpecs (or one bare spec) to NamedShardings on
    ``mesh``.  A tuple entry splits its tensor axis over the named mesh
    dimensions in mesh order, the first one major, as the reference's
    ``NamedSharding`` does."""
    return _tree.tree_map(
        lambda s: NamedSharding(mesh, s, _placements(s, mesh)), specs)
