"""Checkpointing: atomic, async-capable, fingerprint-verified — the legacy
step format of the reference's ``train/checkpoint.py``, byte for byte.

Layout:   <dir>/step_<N>/{0.npy, 1.npy, ..., manifest.json}
Atomicity: written into step_<N>.tmp, every file (and the directory entry)
fsync'd, then os.replace'd — a crash mid-save leaves no manifest at the
final path, so restore skips it, and a crash straddling the rename can
never publish half-flushed file contents.

Leaves are tensors (any device) or numpy arrays in the port's plain trees
(``dist/_tree.py``, named as the reference names them: ``"params/embed"``,
``"opt/step"``).  A bf16 tensor is written as the reference writes one
(numpy's ``<V2`` records, which neither package reads back as bf16: the
legacy format is for f32 training state; ``train/checkpointer.py``'s
``rrns-v1`` format holds bf16).  ``restore`` places the leaves on one
``device``, or with ``shardings=`` reshards them onto the current mesh: a
step stores whole host arrays, so a state saved under one mesh (a ZeRO-1
one included) restores under another.

``save_async`` returns an ``AsyncSave`` handle: exceptions raised on the
writer thread are captured and re-raised from ``join()`` — never silently
dropped — and a second async save to the same (dir, step) while the first
is still in flight is refused (RuntimeError) rather than letting two
writers race on one ``step_<N>.tmp``.

The policy-driven background-queue frontend over this module lives in
``train/checkpointer.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..dist import _tree
from ..dist.fault import (
    find_restorable,
    load_step,
    scan_restorable,
    tensor_fingerprint,
)

__all__ = ["save", "save_async", "restore", "latest_step", "find_restorable",
           "AsyncSave", "commit_dir"]


def _flatten(tree):
    """(names, leaves, spec) in the reference's leaf order and names."""
    named = _tree.flatten_named(tree)
    _, spec = _tree.flatten(tree)
    return [n for n, _ in named], [leaf for _, leaf in named], spec


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_fsync(path: str, writer) -> None:
    """Write ``path`` via ``writer(f)`` and flush it to stable storage."""
    with open(path, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())


def commit_dir(tmp: str, final: str) -> None:
    """Durably publish a fully-written ``tmp`` directory at ``final``:
    fsync the directory entry, atomically replace, fsync the parent so the
    rename itself survives a crash."""
    _fsync_path(tmp)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _fsync_path(os.path.dirname(final) or ".")


def write_npy_header(f, descr: str, shape) -> None:
    """The header ``np.save`` writes for an array of numpy type ``descr``
    (e.g. ``"<i4"``) and ``shape``, C order."""
    np.lib.format.write_array_header_1_0(
        f, {"descr": descr, "fortran_order": False, "shape": tuple(shape)})


def _npy_parts(leaf):
    """(numpy type string, shape, flat uint8 array of the raw bytes) that
    ``np.save`` writes for a leaf — a bf16 tensor as the reference's
    ``ml_dtypes`` array (``<V2`` records)."""
    _refuse_dtensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.int16).numpy().view(np.uint8)
            return "<V2", tuple(t.shape), raw
        leaf = t.numpy()
    a = np.asarray(leaf)
    c = np.ascontiguousarray(a)
    return (np.lib.format.dtype_to_descr(a.dtype), a.shape,
            c.reshape(-1).view(np.uint8))


def save(ckpt_dir: str, step: int, tree, *, extra: dict | None = None) -> str:
    """Synchronous atomic save of a tree of (host or device) tensors."""
    names, leaves, _ = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    fps = []
    for i, leaf in enumerate(leaves):
        descr, shape, raw = _npy_parts(leaf)

        def write(f, descr=descr, shape=shape, raw=raw):
            write_npy_header(f, descr, shape)
            f.write(memoryview(raw))

        _write_fsync(os.path.join(tmp, f"{i}.npy"), write)
        fps.append(tensor_fingerprint(leaf))
    manifest = {
        "step": step,
        "names": names,
        "fingerprints": fps,
        "extra": extra or {},
    }
    _write_fsync(os.path.join(tmp, "manifest.json"),
                 lambda f: f.write(json.dumps(manifest).encode()))
    commit_dir(tmp, final)
    return final


# async saves in flight, keyed by (abs ckpt dir, step) — the guard that
# makes two concurrent writers on one step_<N>.tmp impossible
_inflight: set[tuple[str, int]] = set()
_inflight_lock = threading.Lock()


class AsyncSave:
    """Handle for one in-flight async save.

    ``join()`` waits for the writer thread and RE-RAISES any exception it
    hit (a failed save must surface, never vanish with the thread);
    ``path`` holds the committed directory after a successful join."""

    def __init__(self, ckpt_dir: str, step: int, host_tree, extra):
        self.step = step
        self.path: str | None = None
        self._error: BaseException | None = None
        self._key = (os.path.abspath(ckpt_dir), step)
        with _inflight_lock:
            if self._key in _inflight:
                raise RuntimeError(
                    f"async save to step {step} of {ckpt_dir} already in "
                    f"flight — join() it before saving the same step again"
                )
            _inflight.add(self._key)
        self._thread = threading.Thread(
            target=self._run, args=(ckpt_dir, step, host_tree, extra),
            daemon=True,
        )
        self._thread.start()

    def _run(self, ckpt_dir, step, host_tree, extra):
        try:
            self.path = save(ckpt_dir, step, host_tree, extra=extra)
        except BaseException as e:  # surfaces from join()
            self._error = e
        finally:
            with _inflight_lock:
                _inflight.discard(self._key)

    def join(self, timeout: float | None = None) -> str | None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"save of step {self.step} still running")
        if self._error is not None:
            raise self._error
        return self.path

    def done(self) -> bool:
        return not self._thread.is_alive()


def _refuse_dtensor(leaf) -> None:
    """A step holds whole leaves, as the reference's host arrays do: a
    DTensor is gathered (``full_tensor()``, on every rank) and saved from
    one rank."""
    if hasattr(leaf, "full_tensor"):
        raise TypeError("save whole tensors: gather a DTensor with "
                        "full_tensor() and save from one rank")


def _to_host(leaf):
    _refuse_dtensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone()
    return np.array(leaf, copy=True)


def save_async(ckpt_dir: str, step: int, tree, *, extra=None) -> AsyncSave:
    """Fire-and-join-later save: leaves are copied to host synchronously
    (cheap relative to the write) and the file I/O runs on a thread so the
    train loop's next step overlaps the disk write.  The returned handle's
    ``join()`` re-raises writer-thread exceptions; a concurrent save to the
    same (dir, step) raises RuntimeError immediately."""
    return AsyncSave(ckpt_dir, step, _tree.tree_map(_to_host, tree), extra)


def latest_step(ckpt_dir: str) -> int | None:
    path = find_restorable(ckpt_dir)
    return int(os.path.basename(path).split("_")[1]) if path else None


def as_tensor(arr, device=None) -> torch.Tensor:
    """A loaded host array as a tensor on ``device`` (the CPU when None),
    a 0-d array keeping its rank."""
    a = np.asarray(arr)
    t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    return t if device is None else t.to(device)


def place_leaves(names, flat, shardings, device):
    """The loaded host leaves ``flat[name]`` in ``names`` order: on
    ``device``, or with ``shardings`` (a tree of
    ``dist.sharding.NamedSharding``s in the same leaf order) each one's
    slice for this rank on the mesh, as a DTensor (``place_host``)."""
    if shardings is None:
        return [as_tensor(flat[k], device) for k in names]
    if device is not None:
        raise ValueError("restore: pass shardings= or device=, not both")
    from ..dist.sharding import place_host

    sh = _tree.flatten(shardings)[0]
    if len(sh) != len(names):
        raise ValueError(f"restore: {len(sh)} shardings for {len(names)} "
                         "leaves")
    host = lambda v: v if isinstance(v, torch.Tensor) else as_tensor(v)
    return [place_host(host(flat[k]), s) for k, s in zip(names, sh)]


def restore(ckpt_dir: str, abstract_tree, shardings=None, *,
            step: int | None = None, device=None):
    """Load + verify a checkpoint: ``(tree, step, extra)``.

    ``abstract_tree`` (a tree of tensors, ``meta`` ones included) gives the
    structure; every leaf comes back as a tensor on ``device`` (the CPU
    when None).  ``shardings``, a matching tree of
    ``dist.sharding.NamedSharding``s, places each leaf on the current mesh
    instead: this rank's slice of the host array, wrapped as a DTensor.
    """
    if step is not None:
        path = os.path.join(ckpt_dir, f"step_{step}")
        manifest, flat = load_step(path)  # FileNotFoundError / IOError
    else:
        # scan returns the loaded-and-verified contents, so discovery and
        # restore cost ONE full read + hash of the checkpoint, not two
        found = scan_restorable(ckpt_dir)
        if found is None:
            raise FileNotFoundError(f"no restorable checkpoint under {ckpt_dir}")
        path, manifest, flat = found
    names, _, spec = _flatten(abstract_tree)
    if names != manifest["names"]:
        raise ValueError(
            "checkpoint tree mismatch: "
            f"{set(names) ^ set(manifest['names'])}"
        )
    tree = _tree.unflatten(spec, place_leaves(names, flat, shardings, device))
    return tree, manifest["step"], manifest.get("extra", {})
