"""Loss and train step: next-token CE, grad accumulation, AdamW, metrics —
the reference's ``repro/train/train_step.py`` over parameter trees of
tensors, with autograd for the backward pass.

With a gradient codec the step is the paper's exact data-parallel
aggregation: the whole gradient tree encodes into ONE channel-major int32
wire buffer (``tree_pack_rns``, the codec_encode kernel on the card), that
buffer is the only gradient collective (one ``all_reduce`` over the
process group), and the decode runs at the optimizer boundary inside
``adamw_update`` (the codec_decode kernel).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..dist import _tree
from ..dist.grad_codec import tree_decode, tree_pack_rns
from ..models import train_logits
from .optimizer import AdamWConfig, adamw_update

__all__ = ["AUX_COEF", "make_loss_fn", "make_train_step", "value_and_grad"]

AUX_COEF = 0.01
# Wire columns one RRNS repair pass holds at once: the repair's temporaries
# are a few times this many int32 per channel (about 1.3 GB at 2**24 on a
# five-channel codec), where one pass over a 10**9-element wire would need
# several times the wire itself.
REPAIR_COLUMNS = 1 << 24


def make_loss_fn(cfg):
    """``loss_fn(params, batch) -> (loss, (ce, aux))``: the CE of f32
    logsumexp minus the gold logit, meaned, plus ``AUX_COEF * aux``."""
    def loss_fn(params, batch):
        tokens = batch["tokens"].long()  # (b, s+1)
        inputs = dict(batch, tokens=tokens[:, :-1])
        labels = tokens[:, 1:]
        logits, aux = train_logits(cfg, params, inputs)  # (b, s, V)
        logits = logits.to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        ce = torch.mean(lse - gold)
        return ce + AUX_COEF * aux, (ce, aux)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``(loss, ce, aux, grads)``: the loss and the gradient tree of
    ``loss_fn`` at ``params`` (the parameters themselves are left as they
    are: no ``requires_grad`` state survives the call)."""
    leaves, spec = _tree.flatten(params)
    req = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss, (ce, aux) = loss_fn(_tree.unflatten(spec, req), batch)
        grads = torch.autograd.grad(loss, req)
    return (loss.detach(), ce.detach(), aux.detach(),
            _tree.unflatten(spec, list(grads)))


def psum(t, group):
    """In-place SUM of ``t`` over ``group``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _repair(codec, wire):
    """RRNS locate-and-correct on the local channel-major wire array, in
    place, REPAIR_COLUMNS columns at a time (each column is its own
    codeword, so the passes give the bits of one pass over the whole
    buffer).  Returns the counts of repaired and of unrepairable columns."""
    res = wire.residues
    counts = torch.zeros(2, dtype=torch.int64, device=res.device)
    for a in range(0, res.shape[1], REPAIR_COLUMNS):
        part = codec.as_array(res[:, a : a + REPAIR_COLUMNS],
                              channel_major=True)
        fixed, fault = codec.correct_packed(part)
        res[:, a : a + REPAIR_COLUMNS] = fixed.residues
        counts += torch.stack([(fault >= 0).sum(), (fault == -2).sum()])
    return counts


def make_train_step(
    cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1, rns_codec=None,
    group=None, rns_repair: bool = False, transport_hook=None,
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
    corruption is injected."""
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

    def train_step(params, opt_state, batch):
        loss, ce, aux, grads = grads_of(params, batch)
        metrics = {}
        if rns_codec is None:
            params, opt_state, gnorm = adamw_update(
                opt_cfg, params, grads, opt_state
            )
        else:
            # the wire buffer travels TYPED: one channel-major RnsArray
            # (layout BASE_MA/RRNS per the codec) from encode through
            # repair, the all-reduce and the optimizer-boundary decode
            wire, meta = tree_pack_rns(rns_codec, grads)
            del grads
            if transport_hook is not None:  # fault-injection seam (raw)
                wire = dataclasses.replace(
                    wire, residues=transport_hook(wire.residues)
                )
            if rns_repair:
                counts = psum(_repair(rns_codec, wire), group)
                metrics["repaired"], metrics["unrepairable"] = counts
            psum(wire.residues, group)   # the ONLY gradient collective
            world = float(dist.get_world_size(group))
            params, opt_state, gnorm = adamw_update(
                opt_cfg, params, wire, opt_state,
                grad_decode=lambda s: tree_decode(
                    rns_codec, s, meta, denom=world
                ),
            )
            loss, ce, aux = psum(torch.stack([loss, ce, aux]), group) / world
        # the optimizer's post-update step counter rides along so drivers
        # can check a resume against the loop's own step
        return params, opt_state, {"loss": loss, "ce": ce, "aux": aux,
                                   "gnorm": gnorm,
                                   "opt_step": opt_state["step"], **metrics}

    return train_step
