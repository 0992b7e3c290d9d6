"""Per-device cost accounting of one step on a mesh, and its roofline —
what the reference's ``launch/hlo_costs.py`` and ``launch/hlo_analysis.py``
read out of compiled HLO, taken here from the ops a rank runs.

``LocalCosts`` is a dispatch mode.  For an op on DTensors it returns
``NotImplemented``, so DTensor runs it and the mode sees what DTensor
makes of it on this rank: the local ops on local shards and the
collectives (the trick of ``torch.distributed.tensor.debug.CommDebugMode``).
The fake tensors of the global shapes on which DTensor's sharding
propagation works out an op's output are not counted.  On the rest it
counts:

  * flops        — of the local matmuls, convolutions and attention ops,
                   by ``torch.utils.flop_counter``'s formulas
  * bytes        — every local op's inputs read once and outputs written
                   once: eager ops are the kernels, so their boundaries
                   are the device-memory traffic (no fusion is assumed)
  * collectives  — effective wire bytes a device moves, by kind:

        all-reduce        2 * size   (ring = reduce-scatter + all-gather)
        all-gather        output size
        reduce-scatter    input size
        all-to-all        size

  * live bytes   — the peak of the local tensors alive at once, counted
                   by storage from the op that makes one to the last
                   tensor's release: the step's temporaries and outputs.

Shapes only: it runs as well on ``meta`` tensors over a fake process group
as on real ones.  ``roofline`` turns the counts into three terms in
seconds against the H100 SXM's spec-sheet peaks (``HW``), which are the
vendor's numbers for that card, not measurements.
"""
from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["LocalCosts", "roofline", "HW", "COLLECTIVES"]

# NVIDIA H100 SXM5 80GB spec sheet: dense bf16 tensor-core peak, HBM3
# bandwidth, NVLink 4 bandwidth in one direction.
HW = dict(card="NVIDIA H100 SXM5 80GB (spec sheet)", peak_flops=989e12,
          hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80 * 10**9)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")

_KIND = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(tree):
    """The tensors in nested lists, tuples and dicts (no closure: a
    self-referencing one would keep them alive until the next gc pass)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalCosts(TorchDispatchMode):
    """Counts one rank's local flops, bytes, collectives and peak live
    bytes while active (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collective_ops = {k: 0 for k in COLLECTIVES}
        self.live = 0
        self.peak_live = 0
        self._refs: dict = {}

    def _release(self, key, size):
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= size

    def _track(self, t):
        st = t.untyped_storage()
        key, size = st._cdata, st.nbytes()
        if key not in self._refs:
            self._refs[key] = 0
            self.live += size
            self.peak_live = max(self.peak_live, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, size)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented   # DTensor desugars it into local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or isinstance(
                out, FakeTensor):
            return out   # sharding propagation on global shapes
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", "")
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        self.ops += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _KIND.get(name)
        if kind is not None:
            size_in = sum(_nbytes(t) for t in ins)
            size_out = sum(_nbytes(t) for t in outs)
            self.collectives[kind] += (
                2 * size_out if kind == "all-reduce"
                else size_in if kind == "reduce-scatter"
                else max(size_in, size_out))
            self.collective_ops[kind] += 1
        elif not name.startswith(("wait_tensor", "_wrap_tensor")):
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track(t)
        return out

    def record(self) -> dict:
        coll = dict(self.collectives, ops=sum(self.collective_ops.values()))
        coll["total"] = sum(self.collectives.values())
        coll["ops_by_kind"] = dict(self.collective_ops)
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "local_ops": self.ops, "collectives": coll,
                "peak_live_bytes": self.peak_live}


def roofline(cost: dict, coll: dict) -> dict:
    """Three roofline terms (seconds) from per-device cost/collective data,
    against ``HW``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(coll["total"])
    terms = {
        "compute_s": flops / HW["peak_flops"],
        "memory_s": byts / HW["hbm_bw"],
        "collective_s": cb / HW["link_bw"],
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": cb,
        "hw": HW["card"],
    }
    dom = max(("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    bound = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = (
        terms["compute_s"] / bound if bound > 0 else 0.0
    )
    return terms
