"""Loss and train step: next-token CE, grad accumulation, AdamW, metrics —
the reference's ``repro/train/train_step.py`` over parameter trees of
tensors, with autograd for the backward pass.

With a gradient codec the step is the paper's exact data-parallel
aggregation: the whole gradient tree encodes into ONE channel-major int32
wire buffer (``tree_pack_rns``, the codec_encode kernel on the card), that
buffer is the only gradient collective (one ``all_reduce`` over the
process group), and the decode runs at the optimizer boundary inside
``adamw_update`` (the codec_decode kernel).

On a mesh (``mesh=``, a ``DeviceMesh`` with "data" and "model" axes) the
parameters, the AdamW moments and the batch are DTensors placed by
``dist.sharding``'s spec trees, and the step runs under
``dist.act_sharding.use_mesh``.  The fp32 step lets DTensor reduce the
gradients, pinned to ``grad_shardings``; the codec step computes each
data rank's local gradient on the "model" sub-mesh, encodes its local
shards and sums the wire over the mesh's "data" group.  Either way the
update runs on the moments' placements (ZeRO-1 when ``cfg.zero1`` sharded
them over "data") and the new parameters return to their own.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..dist import _tree
from ..dist.act_sharding import current_mesh, use_mesh
from ..dist.grad_codec import tree_decode, tree_pack_rns
from ..models import train_logits
from ..spans import span, traced
from .optimizer import AdamWConfig, adamw_update

__all__ = ["AUX_COEF", "make_loss_fn", "make_train_step", "value_and_grad"]

AUX_COEF = 0.01


def make_loss_fn(cfg):
    """``loss_fn(params, batch) -> (loss, (ce, aux))``: the CE of f32
    logsumexp minus the gold logit, meaned, plus ``AUX_COEF * aux``."""
    def loss_fn(params, batch):
        tokens = batch["tokens"].long()  # (b, s+1)
        inputs = dict(batch, tokens=tokens[:, :-1])
        labels = tokens[:, 1:]
        logits, aux = train_logits(cfg, params, inputs)  # (b, s, V)
        ce = torch.mean(_token_ce(logits.to(torch.float32), labels))
        return ce + AUX_COEF * aux, (ce, aux)

    return loss_fn


def _lookup(logits, labels):
    """The label's logit at each position: (..., V), (...) -> (...)."""
    return torch.gather(logits, -1, labels[..., None])[..., 0]


@traced("train.ce")
def _token_ce(logits, labels):
    """``logsumexp(logits) - logits[label]`` at each position, (b, s).

    On a mesh nothing of the global (b, s, V) shape may land on a device,
    which DTensor's own ``logsumexp`` and ``gather`` (and the gather's
    backward, a scatter into zeros of the global shape) would do.  With
    the vocabulary split the loss is vocab-parallel: the max and the sum
    of exponentials reduce across the split, and each device looks up the
    labels that fall in its slice of the vocabulary (``local_map``), the
    others adding zero.  Otherwise the same two ops run shard by shard on
    whole rows, which on a (1, 1) mesh is the plain computation."""
    if current_mesh() is None or not hasattr(logits, "placements"):
        return torch.logsumexp(logits, dim=-1) - _lookup(logits, labels)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ..dist.sharding import local_slices

    mesh, last = logits.device_mesh, logits.ndim - 1
    keep = [p if p.is_shard() and p.dim < last else Replicate()
            for p in logits.placements]
    if isinstance(labels, DTensor):
        labels = labels.redistribute(mesh, keep)
    elif all(isinstance(p, Replicate) for p in keep):
        labels = DTensor.from_local(labels, mesh, keep, run_check=False)
    else:
        raise ValueError("the labels must be a DTensor where the logits' "
                         "positions are split")
    if not any(p.is_shard(last) for p in logits.placements):
        logits = logits.redistribute(mesh, keep)
        return local_map(
            lambda lg, lb: torch.logsumexp(lg, dim=-1) - _lookup(lg, lb),
            out_placements=keep, in_placements=(keep, keep),
            device_mesh=mesh)(logits, labels)
    m = logits.detach().amax(dim=-1, keepdim=True).redistribute(mesh, keep)
    se = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    lse = (m + torch.log(se.redistribute(mesh, keep)))[..., 0]
    v0 = local_slices(tuple(logits.shape), mesh, logits.placements)[-1].start

    def lookup(lg, lb):
        idx = lb - v0
        inside = (idx >= 0) & (idx < lg.shape[-1])
        got = _lookup(lg, idx.clamp(0, lg.shape[-1] - 1))
        return torch.where(inside, got, torch.zeros_like(got))

    part = [Partial() if p.is_shard(last) else q
            for p, q in zip(logits.placements, keep)]
    gold = local_map(lookup, out_placements=part,
                     in_placements=(tuple(logits.placements), keep),
                     device_mesh=mesh)(logits, labels)
    return lse - gold


def value_and_grad(loss_fn, params, batch):
    """``(loss, ce, aux, grads)``: the loss and the gradient tree of
    ``loss_fn`` at ``params`` (the parameters themselves are left as they
    are: no ``requires_grad`` state survives the call).  Under a profiler
    the call of ``loss_fn`` is the span ``train.forward`` and its backward
    ``train.backward``."""
    leaves, spec = _tree.flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, (ce, aux) = traced("train.forward", "train.backward")(loss_fn)(
            _tree.unflatten(spec, req), batch)
        grads = torch.autograd.grad(loss, req)
    return (loss.detach(), ce.detach(), aux.detach(),
            _tree.unflatten(spec, list(grads)))


def psum(t, group):
    """In-place SUM of ``t`` over ``group``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _repair(codec, wire):
    """RRNS locate-and-correct on the local channel-major wire array, in
    place: one ``GradCodec.repair_columns_`` call over the whole wire (the
    repair kernel on the card, its plain version elsewhere).  Returns the
    int64 counts of repaired and of unrepairable columns, on the wire's
    device."""
    return codec.repair_columns_(wire.residues)[0][:2]


def _place(t, like):
    """``t`` redistributed to the placements of the DTensor ``like``."""
    if tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


def _zero1_update(opt_cfg, params, grads, opt_state, grad_decode=None):
    """``adamw_update`` on a mesh: gradients, parameters and masters move
    to the moments' placements (a local slice where ZeRO-1 shards the
    moments over "data" and the gradients are replicated there), the
    update runs shard by shard, and the new parameters are gathered back
    to the parameters' own placements."""
    if grad_decode is not None:
        grads = grad_decode(grads)
    moments = opt_state["m"]
    state = dict(opt_state)
    if "master" in state:
        state["master"] = _tree.tree_map(_place, state["master"], moments)
    new_p, state, gnorm = adamw_update(
        opt_cfg, _tree.tree_map(_place, params, moments),
        _tree.tree_map(_place, grads, moments), state)
    return _tree.tree_map(_place, new_p, params), state, gnorm


def _like(g, p):
    """The local shard ``g`` as a DTensor placed as ``p`` is."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(g, p.device_mesh, p.placements, run_check=False)


def make_train_step(
    cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1, grad_shardings=None,
    mesh=None, rns_codec=None, group=None, rns_repair: bool = False,
    transport_hook=None,
):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch["tokens"]`` is a (b, s+1) tensor on the
    parameters' device.

    microbatches: the batch splits into that many equal parts; their
    gradients sum in f32 and scale by ``1/microbatches``.

    rns_codec: optional ``dist.grad_codec.GradCodec``.  Local gradients
    encode to residue channels, the WHOLE tree all-reduces in one int32
    collective over ``group`` (the default process group when None), and
    the decode divides by the group's size inside ``adamw_update``.  Loss
    metrics are averaged over the group.

    rns_repair: with a locate-and-correct codec (``make(correct=True)``),
    RRNS repair runs on the local wire buffer before the all-reduce: fresh
    encodings, so a single corrupted channel per element is located
    exactly and the repaired buffer enters the sum as if the corruption
    never happened.  Adds the ``repaired`` and ``unrepairable`` metrics,
    counts over the group.

    transport_hook: optional ``buf -> buf`` on the raw channel-major wire
    residues between encode and repair/all-reduce — the seam where wire
    corruption is injected.  Without one (and without a mesh) the new
    parameters and moments are views of the dead wire's memory
    (``adamw_update(out=)``); the state passed in is never written to.

    mesh: optional ``DeviceMesh``; the parameters, moments and batch are
    then DTensors on it (module docstring), and the metrics come back as
    plain tensors.  With a codec the wire sums over the mesh's "data"
    group (``group`` must be None), the mesh's axes being ("data",
    "model").

    grad_shardings: optional tree of ``dist.sharding.NamedSharding``s
    matching the parameters (on a mesh).  The gradients are redistributed
    to it before the update, as the reference's
    ``with_sharding_constraint`` pins them to the parameter sharding, so
    that the ZeRO-1 moments reshard at the optimizer boundary."""
    if rns_repair and (rns_codec is None or rns_codec.mb is None):
        raise ValueError(
            "rns_repair requires a locate-and-correct codec: "
            "GradCodec.make(correct=True)"
        )
    loss_fn = make_loss_fn(cfg)

    def grads_of(params, batch):
        if microbatches == 1:
            return value_and_grad(loss_fn, params, batch)
        parts = {k: v.chunk(microbatches) for k, v in batch.items()}
        if any(len(p) != microbatches or p[0].shape != p[-1].shape
               for p in parts.values()):
            raise ValueError(f"the batch does not split into {microbatches} "
                             "equal microbatches")
        g_acc, loss, ce, aux = None, 0.0, 0.0, 0.0
        for i in range(microbatches):
            l, c, a, g = value_and_grad(
                loss_fn, params, {k: v[i] for k, v in parts.items()})
            g = _tree.tree_map(lambda x: x.to(torch.float32), g)
            g_acc = g if g_acc is None else _tree.tree_map(torch.add, g_acc, g)
            loss, ce, aux = loss + l, ce + c, aux + a
        inv = 1.0 / microbatches
        return (loss * inv, ce * inv, aux * inv,
                _tree.tree_map(lambda g: g * inv, g_acc))

    def pin(grads):
        if grad_shardings is None:
            return grads
        return _tree.tree_map(
            lambda g, s: g.redistribute(s.mesh, s.placements),
            grads, grad_shardings)

    update = adamw_update if mesh is None else _zero1_update
    if mesh is not None and rns_codec is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if names != ("data", "model") or group is not None:
            raise ValueError(
                "the codec step on a mesh sums over its 'data' group: it "
                f"needs ('data', 'model') axes, not {names}, and no group")
        group = mesh.get_group("data")

    def local_grads(params, batch):
        """A data rank's own loss and gradient, the gradient as this
        rank's local shards (plain tensors), from the "model" sub-mesh."""
        from torch.distributed.tensor import DTensor

        sub = mesh["model"]
        on_sub = _tree.tree_map(
            lambda p: DTensor.from_local(p.to_local(), sub, [p.placements[1]],
                                         run_check=False), params)
        local = {k: v.to_local() for k, v in batch.items()}
        with use_mesh(sub):
            loss, ce, aux, grads = grads_of(on_sub, local)
            grads = _tree.tree_map(_place, grads, on_sub)
        plain = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        return (plain(loss), plain(ce), plain(aux),
                _tree.tree_map(lambda g: g.to_local(), grads))

    def train_step(params, opt_state, batch):
        with span("train.step"):
            if mesh is None:
                return _step(params, opt_state, batch)
            with use_mesh(mesh):
                params, opt_state, metrics = _step(params, opt_state, batch)
            return params, opt_state, {
                k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in metrics.items()}

    # the codec step's new state goes into its dead wire (``adamw_update``'s
    # ``out``) when no mesh or hook is in the way (the step's end, below)
    into_wire = (rns_codec is not None and mesh is None
                 and transport_hook is None)

    def _step(params, opt_state, batch):
        wire_out = None
        if into_wire:
            # the wire's block is the step's first allocation, made while
            # the previous step's temporaries are all free: the block that
            # held the state before the last, once its caller has let it go
            leaves = _tree.flatten(params)[0]
            wire_out = torch.empty(
                (rns_codec.n_channels, sum(l.numel() for l in leaves)),
                dtype=torch.int32, device=leaves[0].device)
        if mesh is not None and rns_codec is not None:
            loss, ce, aux, grads = local_grads(params, batch)
        else:
            loss, ce, aux, grads = grads_of(params, batch)
            grads = pin(grads)
        metrics = {}
        if rns_codec is None:
            with span("optim.adamw"):
                params, opt_state, gnorm = update(
                    opt_cfg, params, grads, opt_state
                )
        else:
            # the wire buffer travels TYPED: one channel-major RnsArray
            # (layout BASE_MA/RRNS per the codec) from encode through
            # repair, the all-reduce and the optimizer-boundary decode
            with span("codec.pack"):
                wire, meta = tree_pack_rns(rns_codec, grads, out=wire_out)
            del grads
            if transport_hook is not None:  # fault-injection seam (raw)
                wire = dataclasses.replace(
                    wire, residues=transport_hook(wire.residues)
                )
            if rns_repair:
                with span("codec.repair"):
                    counts = _repair(rns_codec, wire)
                counts = psum(counts, group)
                metrics["repaired"], metrics["unrepairable"] = counts
            with span("codec.wire"):
                psum(wire.residues, group)   # the ONLY gradient collective
            world = float(dist.get_world_size(group))
            # once decoded the wire is dead: without a hook that could keep
            # it, the new parameters and moments go into its block, so the
            # steps take the same two wire-sized blocks in turn; otherwise
            # the decode empties the box, and a wire that nothing else holds
            # is freed before the update makes the new state
            kw = {"out": wire.residues} if into_wire else {}
            box = [wire]
            del wire
            decode = lambda b: tree_decode(rns_codec, b.pop(), meta,
                                           denom=world)
            if mesh is not None:   # local shards back under their placements
                decode = lambda b, d=decode: _tree.tree_map(_like, d(b),
                                                            params)
            with span("optim.adamw"):
                params, opt_state, gnorm = update(
                    opt_cfg, params, box, opt_state, grad_decode=decode,
                    **kw)
            loss, ce, aux = psum(torch.stack([loss, ce, aux]), group) / world
        # the optimizer's post-update step counter rides along so drivers
        # can check a resume against the loop's own step
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux,
                                   "gnorm": gnorm,
                                   "opt_step": opt_state["step"], **metrics}

    return train_step
