"""Mesh-aware activation placement: the reference's
``repro/dist/act_sharding.py`` on ``DTensor``.

Model code annotates activations with LOGICAL axis names::

    x = constrain(x, "batch", None, "heads", None)

and this module resolves them to ``Shard``/``Replicate`` placements on the
mesh that ``use_mesh`` installed, then redistributes the ``DTensor`` to
them.  With no mesh active ``constrain`` returns its argument untouched
after one context-variable read, so the same model code runs on plain
tensors on one card and on DTensors over a mesh.

Logical -> physical mapping (``logical_to_physical``, the reference's):

    batch                  -> the data axes ("pod", "data"), outermost kept
                              on divisibility fallback
    heads/kv/ff/dinner/
    experts/vocab/seq      -> "model"
    ?seq                   -> "model", soft: only if no other axis in the
                              same call claimed it
    ?batch_plus            -> data axes PLUS "model" when unclaimed

Every assignment is divisibility-checked against the global dim, and a mesh
axis is never assigned twice within one call.

``use_mesh`` also enters ``implicit_replication()``: the tensors a model
makes for itself mid-forward (rope's tables, masks, positions, scalars) are
plain tensors, and they meet DTensors as replicated values.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import threading

from .sharding import PartitionSpec, mesh_axes, named_shardings

__all__ = ["use_mesh", "current_mesh", "constrain", "logical_to_physical"]

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_active_mesh", default=None
)

# logical names that map to the tensor-parallel axis
_MODEL_NAMES = frozenset(
    {"heads", "kv", "ff", "dinner", "experts", "vocab", "embed", "model", "seq"}
)


# ``implicit_replication()`` sets a process-wide flag and clears it on
# exit, whatever it was: ``use_mesh`` blocks, nested or open at once on
# several threads (a backward's recompute runs on the autograd engine's),
# share one entry of it, held while any of them is open.
_REPLICATION = {"open": 0, "ctx": None}
_REPLICATION_LOCK = threading.Lock()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor.experimental import implicit_replication

    with _REPLICATION_LOCK:
        if not _REPLICATION["open"]:
            _REPLICATION["ctx"] = implicit_replication()
            _REPLICATION["ctx"].__enter__()
        _REPLICATION["open"] += 1
    try:
        yield
    finally:
        with _REPLICATION_LOCK:
            _REPLICATION["open"] -= 1
            if not _REPLICATION["open"]:
                _REPLICATION["ctx"].__exit__(None, None, None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the active mesh for ``constrain`` calls, inside
    ``implicit_replication()`` when it is a mesh.  Nests;
    ``use_mesh(None)`` disables constraints inside an outer active mesh."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with _implicit_replication():
                yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def current_mesh():
    """The mesh installed by the innermost ``use_mesh``, or None."""
    return _ACTIVE_MESH.get()


def _data_axes(sizes) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _fit(dim: int, axes: tuple[str, ...], sizes) -> tuple[str, ...]:
    """Longest prefix-preserving assignment: drop axes from the END until the
    remaining product divides ``dim`` (keeps 'data' when 'model' doesn't fit,
    keeps 'pod' before 'data', etc.)."""
    while axes:
        prod = math.prod(sizes[a] for a in axes)
        if prod <= 1 or dim % prod == 0:
            return axes if prod > 1 else ()
        axes = axes[:-1]
    return ()


def logical_to_physical(mesh, names, shape):
    """Resolve logical axis names to a PartitionSpec for ``shape`` on ``mesh``.

    Hard names resolve first (left to right), soft ``?``-prefixed names claim
    whatever is left.  Returns None when nothing shards.
    """
    if len(names) != len(shape):
        raise ValueError(f"{len(names)} names for rank-{len(shape)} tensor")
    sizes = mesh_axes(mesh)
    entries: list = [None] * len(names)
    claimed: set[str] = set()

    def assign(i, axes):
        axes = _fit(shape[i], tuple(a for a in axes if a not in claimed), sizes)
        if axes:
            entries[i] = axes[0] if len(axes) == 1 else axes
            claimed.update(axes)

    for i, nm in enumerate(names):
        if nm is None or nm.startswith("?"):
            continue
        if nm == "batch":
            assign(i, _data_axes(sizes))
        elif nm in _MODEL_NAMES:
            if "model" in sizes:
                assign(i, ("model",))
        else:
            raise ValueError(f"unknown logical axis {nm!r}")

    for i, nm in enumerate(names):
        if nm is None or not nm.startswith("?"):
            continue
        key = nm[1:]
        if key == "batch_plus":
            cand = _data_axes(sizes)
            if "model" in sizes:
                cand = cand + ("model",)
            assign(i, cand)
        elif key in _MODEL_NAMES:
            if "model" in sizes:
                assign(i, ("model",))
        else:
            raise ValueError(f"unknown logical axis {nm!r}")

    if all(e is None for e in entries):
        return None
    return PartitionSpec(*entries)


def constrain(x, *names):
    """Place ``x`` by logical axis names — a no-op off a mesh.

    ``names`` has one entry per tensor axis: a logical name, a soft
    ``"?"``-prefixed name, or None.  On a mesh a DTensor is redistributed
    to the resolved placements, replicated on the mesh axes no name
    claims; a plain tensor, or names that shard nothing, leave ``x`` as it
    is (the reference then adds no constraint either).
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = logical_to_physical(mesh, names, tuple(x.shape))
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(x, DTensor):
        return x
    placements = named_shardings(spec, x.device_mesh).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)
