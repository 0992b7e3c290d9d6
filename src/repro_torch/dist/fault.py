"""Fault detection and repair for checkpoints and tensor transport.

Content fingerprints (sha256 over dtype, shape and raw bytes) catch single
bit flips in saved or relayed tensors; ``find_restorable`` walks a
checkpoint directory newest-first and returns the first step whose manifest
AND tensor contents verify, so torn saves (no manifest) and corrupt steps
are skipped.  The fingerprints are byte-equal to the reference's for the
same data, bf16 included, and the ``load_*`` functions read the step
directories the reference's ``train/checkpoint.py`` writes.

``repair_packed`` is the finer-grained companion for RNS-codec buffers: a
codec built with ``GradCodec.make(correct=True)`` carries two redundant
residue channels, so a single corrupted channel per element is located and
CORRECTED in place.  ``WireStore`` keeps such codewords under keys, with
detect / repair / fault-injection methods.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from . import _tree

__all__ = [
    "tensor_fingerprint",
    "tree_fingerprints",
    "verify_fingerprints",
    "load_step",
    "load_verified",
    "scan_restorable",
    "find_restorable",
    "repair_packed",
    "WireStore",
]


def repair_packed(codec, packed, *, wraps: int = 0,
                  channel_major: bool = False):
    """Locate-and-correct a packed RNS codec buffer (wire or checkpoint).

    ``packed`` is leaf-major ``(..., n_channels)`` by default or the wire's
    channel-major ``(n_channels, B)`` with ``channel_major=True``, or a
    typed ``RnsArray`` (whose own channel axis wins; it comes back typed).
    ``wraps`` is 0 for fresh encodings, normalized sums and checkpointed
    state, ``world - 1`` for a raw post-psum buffer.

    Returns ``(repaired, report)``: ``report["repaired"]`` counts elements
    whose single bad channel was rebuilt, ``report["unrecoverable"]`` those
    with multi-channel corruption (left untouched).  A clean buffer comes
    back unchanged with both counts zero.
    """
    from ..core.array import RnsArray

    if isinstance(packed, RnsArray):
        fixed, fault = codec.correct_packed(packed, wraps=wraps)
    else:
        buf = packed.T if channel_major else packed
        fixed, fault = codec.correct_packed(buf, wraps=wraps)
        fixed = fixed.T if channel_major else fixed
    report = {
        "repaired": int((fault >= 0).sum()),
        "unrecoverable": int((fault == -2).sum()),
    }
    return fixed, report


class WireStore:
    """Keyed store of typed RRNS wire codewords with detect/repair.

    Each entry is a channel-major ``RnsArray`` (the output of
    ``codec.encode_array(..., channel_major=True)``) under any hashable key.

    ``stats`` accumulates across the store's lifetime:
      verified / failed           — ``matches`` outcomes (content checks)
      wire_ok / wire_corrupt      — ``ok`` outcomes (codeword self-checks)
      repaired / unrecoverable    — summed ``repair`` reports
    """

    def __init__(self, codec):
        self.codec = codec
        self.raw: dict = {}
        self.stats = {"verified": 0, "failed": 0, "wire_ok": 0,
                      "wire_corrupt": 0, "repaired": 0, "unrecoverable": 0}

    def __contains__(self, key) -> bool:
        return key in self.raw

    def __len__(self) -> int:
        return len(self.raw)

    def keys(self):
        return self.raw.keys()

    def put(self, key, arr) -> None:
        self.raw[key] = arr

    def get(self, key):
        return self.raw[key]

    def pop(self, key, default=None):
        return self.raw.pop(key, default)

    def clear(self) -> None:
        self.raw.clear()

    def matches(self, key, fresh) -> bool:
        """Bitwise compare a freshly encoded codeword with the stored one."""
        ok = bool(torch.equal(fresh.residues, self.raw[key].residues))
        self.stats["verified" if ok else "failed"] += 1
        return ok

    def ok(self, key) -> bool:
        """Redundant-channel self-consistency of the stored codeword."""
        good = bool(self.codec.verify_packed(self.raw[key]).all())
        self.stats["wire_ok" if good else "wire_corrupt"] += 1
        return good

    def repair(self, key) -> dict:
        """Locate-and-correct the stored codeword in place
        (``repair_packed``); returns the call's report."""
        fixed, report = repair_packed(self.codec, self.raw[key], wraps=0)
        self.raw[key] = fixed
        self.stats["repaired"] += report["repaired"]
        self.stats["unrecoverable"] += report["unrecoverable"]
        return report

    def corrupt(self, key, channel: int = 0, delta: int = 1,
                index: int = 0) -> None:
        """Fault injection: bump one residue of the stored codeword modulo
        its channel's modulus (still a valid residue, so only the redundant
        channels can catch it)."""
        arr = self.raw[key]
        mods = tuple(self.codec.base.moduli) + self.codec.redundant
        res = arr.residues.clone()
        res[channel, index] = (res[channel, index] + delta) % mods[channel]
        self.raw[key] = dataclasses.replace(arr, residues=res)


def _host_bytes(arr) -> tuple[str, tuple, np.ndarray]:
    """(dtype name, shape, raw C-order bytes as a flat uint8 array) of a
    tensor or array, with the reference's dtype names (numpy's;
    ``bfloat16`` for bf16) and its shapes (a 0-d leaf hashes as (1,), as
    ``np.ascontiguousarray`` makes it)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.int16).numpy().view(np.uint8)
            return "bfloat16", tuple(t.shape) or (1,), raw
        arr = t.numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    return str(a.dtype), a.shape, a.reshape(-1).view(np.uint8)


def fingerprint_hasher(dtype: str, shape: tuple):
    """A sha256 fed the fingerprint's prefix: ``tensor_fingerprint`` is its
    first 32 hex digits once the leaf's raw bytes follow (in any number of
    ``update`` calls)."""
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str(tuple(shape) or (1,)).encode())
    return h


def tensor_fingerprint(arr) -> str:
    """Content hash of one tensor or array: dtype, shape, raw bytes."""
    dtype, shape, raw = _host_bytes(arr)
    h = fingerprint_hasher(dtype, shape)
    h.update(memoryview(raw))
    return h.hexdigest()[:32]


def tree_fingerprints(tree) -> dict[str, str]:
    """{name: fingerprint} for every leaf, in the reference's leaf order."""
    return {name: tensor_fingerprint(leaf)
            for name, leaf in _tree.flatten_named(tree)}


def verify_fingerprints(tree, fingerprints: dict[str, str]) -> list[str]:
    """Names of leaves whose content does NOT match ``fingerprints`` (a
    missing expected fingerprint counts as a mismatch)."""
    return [name for name, leaf in _tree.flatten_named(tree)
            if fingerprints.get(name) != tensor_fingerprint(leaf)]


def load_step(path: str):
    """Load + verify one ``step_<N>`` dir: (manifest, {name: array}).

    Raises FileNotFoundError for a torn save (no manifest) or a missing
    tensor file, IOError naming the bad leaves on fingerprint mismatch."""
    manifest_path = os.path.join(path, "manifest.json")
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no manifest under {path} (torn save?)")
    with open(manifest_path) as f:
        manifest = json.load(f)
    flat = {
        name: np.load(os.path.join(path, f"{i}.npy"))
        for i, name in enumerate(manifest["names"])
    }
    bad = verify_fingerprints(
        flat, dict(zip(manifest["names"], manifest["fingerprints"]))
    )
    if bad:
        raise IOError(f"checkpoint {path} corrupt: {bad}")
    return manifest, flat


def load_verified(path: str):
    """Quiet variant of ``load_step``: None for torn/unreadable/corrupt."""
    try:
        return load_step(path)
    except Exception:
        return None


def scan_restorable(ckpt_dir: str):
    """Newest fully-verified step: (path, manifest, {name: array}) or None
    (the contents come back loaded, so nothing is read and hashed twice)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append((int(d.split("_", 1)[1]), d))
            except ValueError:
                continue
    for _, d in sorted(steps, reverse=True):
        path = os.path.join(ckpt_dir, d)
        loaded = load_verified(path)
        if loaded is not None:
            return (path,) + loaded
    return None


def find_restorable(ckpt_dir: str) -> str | None:
    """Path of the newest fully-verified ``step_<N>`` directory, else None."""
    found = scan_restorable(ckpt_dir)
    return found[0] if found else None
