"""Named spans of the port's work, on the profiler's clock.

While a ``torch.profiler`` session records (the training CLI's
``--profile-start-step`` window, a benchmark's traced steps), ``span(name)``
opens a ``record_function`` range: a range on the host in the Chrome trace
and, around the CUDA kernels launched inside it, a ``gpu_user_annotation``
range on the device.  ``traced(name)`` makes a function's call such a span
and, where gradients flow through the call, gives it a backward twin, the
span ``<name>.bwd``: opened when the gradients of the call's outputs
arrive and closed once every gradient of its inputs is out.  Two identity
autograd nodes open and close the twin, so it runs on the thread that
launches the backward's kernels (the autograd engine's device thread on a
card), where a range opened around ``autograd.grad`` on the caller's
thread would see none of them.

With no session the switch is one boolean: no range, hook or autograd node
is made, and arguments and results pass untouched.

The profiler puts each kernel under the innermost range open on the
launching thread, and a range's device time runs from the first to the
last of its own kernels.  So inside a backward, where the recomputation of
a remat unit (``models.layers.remat``) is the span ``remat.recompute``,
``traced`` opens no span: nested spans there would take the recomputed
kernels from ``remat.recompute`` and leave its device range at the unit's
first few kernels.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd.profiler import record_function

__all__ = ["span", "backward_span", "traced"]

_OFF = contextlib.nullcontext()


def _recording() -> bool:
    return torch.autograd._profiler_enabled()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def span(name: str):
    """A ``record_function(name)`` range while a profiler session records,
    else a shared no-op context."""
    return record_function(name) if _recording() else _OFF


def backward_span(name: str):
    """``span(name)`` when entered inside a backward pass (a remat unit's
    recomputation), else a no-op: the unit's forward is not the span."""
    return record_function(name) if _recording() and _in_backward() else _OFF


class _Twin:
    """The backward range of one call, shared by its two identity nodes."""

    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name, self.range = name, None


class _Identity(torch.autograd.Function):
    """Identity on a call's tensors, a node of its backward; the None
    gradients of unused outputs stay None."""

    @staticmethod
    def forward(ctx, twin, *ts):
        ctx.twin = twin
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in ts)


class _Open(_Identity):
    """On a call's outputs; its backward, the first node of the call's
    backward, opens the twin."""

    @staticmethod
    def backward(ctx, *grads):
        twin = ctx.twin
        if twin.range is None:
            twin.range = record_function(twin.name).__enter__()
        return (None, *grads)


class _Close(_Identity):
    """On a call's inputs; its backward, run once every input's gradient
    is in, closes the twin."""

    @staticmethod
    def backward(ctx, *grads):
        rng, ctx.twin.range = ctx.twin.range, None
        if rng is not None:
            rng.__exit__(None, None, None)
        return (None, *grads)


def _grad_tensors(tree, out: list) -> list:
    """The tensors that require grad in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        if tree.requires_grad:
            out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _grad_tensors(v, out)
    elif type(tree) in (list, tuple):
        for v in tree:
            _grad_tensors(v, out)
    return out


def _replace(tree, new: dict):
    """``tree`` with each tensor whose id is in ``new`` replaced."""
    if isinstance(tree, torch.Tensor):
        return new.get(id(tree), tree)
    if isinstance(tree, dict):
        return {k: _replace(v, new) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_replace(v, new) for v in tree)
    return tree


def _through(node, twin, tree, ts):
    """``tree`` with its tensors ``ts`` (those that require grad) passed
    through ``node``."""
    return _replace(tree, dict(zip(map(id, ts), node.apply(twin, *ts))))


def traced(name: str, bwd: str | None = None):
    """Decorator: each call of the function outside a backward pass is
    ``span(name)``; where gradients flow from its outputs to its arguments
    (nested dicts, lists and tuples of tensors), its backward is the span
    ``bwd``, by default ``<name>.bwd``."""
    bwd = bwd or name + ".bwd"

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            if not _recording() or _in_backward():
                return fn(*args, **kw)
            with record_function(name):
                ts = _grad_tensors((args, kw), []) if (
                    torch.is_grad_enabled()) else None
                if not ts:
                    return fn(*args, **kw)
                twin = _Twin(bwd)
                args, kw = _through(_Close, twin, (args, kw), ts)
                out = fn(*args, **kw)
                ts = _grad_tensors(out, [])
                return _through(_Open, twin, out, ts) if ts else out

        return run

    return wrap
