"""Policy-driven async checkpointer with RRNS repair-on-restore — the
reference's ``train/checkpointer.py`` (its DESIGN.md §14), writing and
reading the reference's ``rrns-v1`` step directories byte for byte.

Three layers:

1. **Policy** — ``SavePolicy`` combines overlapping step intervals
   (``every@until`` schedules: save often early, less often late) with a
   wall-clock interval; ``parse_policy`` reads the ``--ckpt-policy``
   grammar (``"2@10,5,30s"``).

2. **Checkpointer** — ONE background writer thread fed by a bounded queue:
   ``maybe_save`` snapshots the tree (a copy of every leaf on its own
   device, made before it returns) and enqueues it (blocking when the queue
   is full, so saves can overlap training but never pile up); writer-thread
   exceptions are held and re-raised from the next ``wait()`` /
   ``close()`` / ``maybe_save()``, never dropped.  Each commit is
   write-to-``step_<N>.tmp`` + fsync + atomic rename
   (``checkpoint.commit_dir``), followed by retention GC (``keep`` newest).

3. **RRNS shard format** — each leaf is stored as the RRNS codeword of its
   raw bytes: the byte buffer, padded to a multiple of 4, is read as
   uint32 limbs ``q < 2**32``, and the wire file ``i.rns.npy`` holds
   ``wire[c, j] = q_j mod m_c`` for the 3 base + 2 redundant channels of
   ``GradCodec.make(world=1, correct=True)`` (int32, channel-major).
   Since ``q < 2**32 << M ~ 2**44`` the encoding is LOSSLESS — restore
   decodes by mixed radix over the base channels and checks the sha256
   content fingerprint end to end.  On mismatch the elements whose five
   residues are not one codeword are gathered and ``fault.repair_packed``
   locates and rebuilds the single corrupted channel of each (a bit flip
   anywhere in the file damages exactly one ``(channel, element)``
   residue); multi-channel damage refuses (verdict -2) and restore falls
   back to the next restorable step.  Storage cost: 5 int32 channels per
   uint32 word = 5x.

The encode and the decode run in passes of ``CHUNK`` limbs on the device
the leaf lives on (``restore``'s ``device=`` for the decode), so a leaf of
any size costs a bounded transient: a full-width training state streams
from the card to disk, and back, a chunk at a time.  On the card the
writer's passes run on a stream of their own, beside the training step.
A restore onto a mesh (``shardings=``) decodes on the mesh's device into
host leaves, whose slices for this rank then go to the device.

Crash injection for the kill-and-resume harness: set
``REPRO_CKPT_CRASH_STEP=<n>`` (and optionally
``REPRO_CKPT_CRASH_FILES=<k>``, default 1) and the writer SIGKILLs its own
process after the k-th leaf file of step n is written — before the
manifest and the atomic rename, leaving a torn ``step_<n>.tmp`` that
discovery never sees.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import queue
import shutil
import signal
import threading
import time

import numpy as np
import torch

from ..core.base import RNSBase
from ..dist import _tree
from ..dist.fault import fingerprint_hasher, load_step, repair_packed
from ..dist.grad_codec import GradCodec
from ..dist.sharding import mesh_device
from .checkpoint import (_flatten, _refuse_dtensor, _write_fsync, as_tensor,
                         commit_dir, place_leaves, write_npy_header)

__all__ = [
    "StepInterval", "SavePolicy", "parse_policy",
    "CheckpointCorrupt", "ckpt_codec", "codec_from_manifest",
    "leaf_to_wire", "wire_to_leaf",
    "write_step_dir", "read_step_dir",
    "discover_steps", "discover_latest",
    "inject_channel_corruption", "Checkpointer", "restore",
]

FORMAT = "rrns-v1"
CRASH_STEP_ENV = "REPRO_CKPT_CRASH_STEP"
CRASH_FILES_ENV = "REPRO_CKPT_CRASH_FILES"
CHUNK = 1 << 24          # limbs per encode / decode pass (64 MiB of int32)
_MASK32 = 0xFFFFFFFF


class CheckpointCorrupt(IOError):
    """A step directory whose damage exceeds single-channel repair —
    truncated/unloadable wire file, verdict -2 elements, or a content
    fingerprint that still mismatches after repair."""


# ---------------------------------------------------------------------------
# save policy


@dataclasses.dataclass(frozen=True)
class StepInterval:
    """Save every ``every`` steps while ``step <= until`` (None = forever)."""

    every: int
    until: int | None = None


@dataclasses.dataclass(frozen=True)
class SavePolicy:
    """Overlapping step-based and time-based save schedules.

    ``intervals`` are consulted in order: the FIRST whose ``until`` covers
    the step decides the step cadence (so ``2@10,5`` = every 2 steps up to
    step 10, every 5 after).  ``every_seconds`` fires independently of the
    step schedule — whichever is due first wins.

    >>> p = parse_policy("2@10,5,30s")
    >>> [s for s in range(1, 21) if p.step_due(s)]
    [2, 4, 6, 8, 10, 15, 20]
    >>> p.every_seconds
    30.0
    >>> p.time_due(now=61.0, last=30.0), p.time_due(now=40.0, last=30.0)
    (True, False)
    """

    intervals: tuple[StepInterval, ...] = ()
    every_seconds: float | None = None

    def step_due(self, step: int) -> bool:
        if step <= 0:
            return False
        for iv in self.intervals:
            if iv.until is None or step <= iv.until:
                return step % iv.every == 0
        return False

    def time_due(self, *, now: float, last: float) -> bool:
        return (self.every_seconds is not None
                and now - last >= self.every_seconds)


def parse_policy(spec) -> SavePolicy:
    """Parse the ``--ckpt-policy`` grammar: comma-separated terms, each
    ``N`` (every N steps), ``N@M`` (every N steps up to step M), ``Ns`` /
    ``Nm`` (every N seconds / minutes of wall clock; at most one).

    >>> parse_policy("5")
    SavePolicy(intervals=(StepInterval(every=5, until=None),), every_seconds=None)
    >>> parse_policy("45s").every_seconds
    45.0
    >>> parse_policy("2@10,5").intervals
    (StepInterval(every=2, until=10), StepInterval(every=5, until=None))
    >>> parse_policy("0")
    Traceback (most recent call last):
        ...
    ValueError: save interval must be >= 1 step: '0'
    """
    if isinstance(spec, SavePolicy):
        return spec
    intervals: list[StepInterval] = []
    secs = None
    for term in str(spec).split(","):
        term = term.strip()
        if not term:
            continue
        if term[-1] in "sm" and term[:-1]:
            if secs is not None:
                raise ValueError(f"more than one time term in policy {spec!r}")
            secs = float(term[:-1]) * (60.0 if term[-1] == "m" else 1.0)
            if secs <= 0:
                raise ValueError(f"time interval must be > 0: {term!r}")
            continue
        every, at, until = term.partition("@")
        if at and not until:
            raise ValueError(f"dangling '@' in policy term {term!r}")
        iv = StepInterval(int(every), int(until) if until else None)
        if iv.every < 1:
            raise ValueError(f"save interval must be >= 1 step: {term!r}")
        intervals.append(iv)
    # bounded intervals first, in increasing reach, so step_due's first
    # covering interval is the most specific one
    intervals.sort(key=lambda iv: (iv.until is None, iv.until or 0))
    if sum(iv.until is None for iv in intervals) > 1:
        raise ValueError(f"more than one unbounded step term in {spec!r}")
    return SavePolicy(tuple(intervals), secs)


# ---------------------------------------------------------------------------
# RRNS leaf wire format


@functools.lru_cache(maxsize=None)
def ckpt_codec() -> GradCodec:
    """The checkpoint codec: world=1 RRNS (3 base + m_a + m_b channels),
    the exact path (repair runs wherever the gathered columns are)."""
    return GradCodec.make(world=1, correct=True, fused=False)


@functools.lru_cache(maxsize=None)
def _codec_for(moduli: tuple, ma: int, mb: int, bits: int) -> GradCodec:
    return GradCodec(base=RNSBase(moduli=moduli, ma=ma, bits=bits),
                     frac_bits=16, world=1, fused=False, mb=mb)


def codec_from_manifest(manifest: dict) -> GradCodec:
    """Rebuild the exact codec a manifest's wire files were written under —
    checkpoints stay readable if the default codec ever changes."""
    c = manifest["codec"]
    return _codec_for(tuple(c["moduli"]), c["ma"], c["mb"], c["bits"])


def _all_moduli(codec: GradCodec) -> tuple:
    return tuple(int(m) for m in codec.base.moduli) + tuple(
        int(m) for m in codec.redundant)


def _leaf_bytes(leaf):
    """(dtype name, shape, nbytes, flat uint8 tensor of the raw C-order
    bytes on the leaf's device): the reference's names (numpy's,
    ``bfloat16`` for bf16), a 0-d leaf keeping its rank."""
    _refuse_dtensor(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        name = ("bfloat16" if t.dtype == torch.bfloat16 else
                str(torch.empty(0, dtype=t.dtype).numpy().dtype))
        return (name, tuple(t.shape), t.numel() * t.element_size(),
                t.reshape(-1).view(torch.uint8))
    a = np.asarray(leaf)
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return str(a.dtype), a.shape, a.nbytes, torch.from_numpy(raw)


def _limbs(raw: torch.Tensor) -> torch.Tensor:
    """The raw bytes, zero-padded to a multiple of 4, as int32 limbs."""
    pad = -raw.numel() % 4
    if pad or raw.storage_offset() % 4:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32)


def _encode(limbs: torch.Tensor, m: int) -> torch.Tensor:
    """Channel ``m`` of the limbs' codeword: ``uint32(limb) mod m``."""
    return torch.remainder(limbs.to(torch.int64) & _MASK32, m).to(torch.int32)


def _digits(rows, moduli: tuple) -> list:
    """Mixed-radix digits (Garner) of the integers whose base residues are
    ``rows`` (n, k): ``q = d0 + d1*m0 + d2*m0*m1 + ...``, each digit in
    int64 below its modulus; ``q`` is the CRT value, below M."""
    digits = []
    for i, m in enumerate(moduli):
        t = rows[i].to(torch.int64)
        for j, d in enumerate(digits):
            t = torch.remainder((t - d) * pow(moduli[j], -1, m), m)
        digits.append(t)
    return digits


def _value_mod(digits: list, moduli: tuple, m: int):
    """``q mod m`` of the mixed-radix digits (``m`` = 2**32 gives the low
    word), in int64."""
    acc, radix = torch.zeros_like(digits[0]), 1
    for d, mi in zip(digits, moduli):
        acc = torch.remainder(acc + d * (radix % m), m)
        radix *= mi
    return acc


def _decode(rows, moduli: tuple) -> torch.Tensor:
    """int32 limbs (the low 32 bits of the CRT value, bit for bit) of base
    residue rows (n, k)."""
    low = _value_mod(_digits(rows, moduli), moduli, 1 << 32)
    return torch.where(low >= 1 << 31, low - (1 << 32), low).to(torch.int32)


def _bytes_as(raw: torch.Tensor, dtype: str, shape):
    """A leaf of numpy type name ``dtype`` from its raw bytes: a tensor on
    the bytes' device, or a host numpy array for a type torch lacks."""
    if dtype == "bfloat16":
        td = torch.bfloat16
    else:
        try:
            td = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        except TypeError:
            return np.frombuffer(raw.cpu().numpy().tobytes(),
                                 dtype=dtype).reshape(tuple(shape))
    return raw.view(td).reshape(tuple(shape))


def leaf_to_wire(codec: GradCodec, arr) -> np.ndarray:
    """Lossless RRNS codeword of one leaf's raw bytes, channel-major int32
    (the contents of its ``i.rns.npy``).

    >>> codec = ckpt_codec()
    >>> w = leaf_to_wire(codec, np.arange(3, dtype=np.float32))
    >>> w.shape, w.dtype                       # 5 channels, 3 uint32 limbs
    ((5, 3), dtype('int32'))
    >>> wire_to_leaf(codec, w, "float32", (3,), 12).tolist()
    [0.0, 1.0, 2.0]
    """
    limbs = _limbs(_leaf_bytes(arr)[3])
    return torch.stack([_encode(limbs, m) for m in _all_moduli(codec)]
                       ).cpu().numpy()


def wire_to_leaf(codec: GradCodec, wire, dtype, shape, nbytes: int):
    """Decode a wire codeword back to the original leaf (base channels only
    — the redundant rows are for locate-and-correct): a tensor on the
    wire's device (the CPU for a numpy wire)."""
    w = (wire if isinstance(wire, torch.Tensor)
         else torch.from_numpy(np.asarray(wire)))
    moduli = tuple(int(m) for m in codec.base.moduli)
    limbs = _decode(w[: len(moduli)], moduli)
    return _bytes_as(limbs.view(torch.uint8)[:nbytes], str(dtype), shape)


# ---------------------------------------------------------------------------
# step-dir IO


def _maybe_crash(step: int, files_written: int) -> None:
    want = os.environ.get(CRASH_STEP_ENV)
    if want is None or int(want) != step:
        return
    if files_written >= int(os.environ.get(CRASH_FILES_ENV, "1")):
        os.kill(os.getpid(), signal.SIGKILL)  # torn save, by design


def _drop_cache(f) -> None:
    """Release a written file's pages from the page cache (after fsync):
    a checkpoint is not read again by the process that wrote it."""
    if hasattr(os, "posix_fadvise"):
        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_DONTNEED)


class _Staging:
    """Chunk buffers between a device and the files: pinned host memory
    and a stream of the writer's own for a CUDA device (the copies overlap
    the training step's kernels), plain host memory for the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.host = (torch.empty(CHUNK, dtype=torch.int32, pin_memory=True)
                     if cuda else None)

    def context(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """The int32 or uint8 chunk ``t`` as host bytes (a view of the
        staging buffer until the next call)."""
        if self.stream is None:
            return t.numpy().view(np.uint8)
        flat = t.reshape(-1).view(torch.uint8)
        host = self.host.view(torch.uint8)[: flat.numel()]
        host.copy_(flat, non_blocking=True)
        self.stream.synchronize()
        return host.numpy()


def _write_leaf(path: str, codec: GradCodec, leaf, staging_for, timings):
    """Stream one leaf's codeword into ``path`` (npy, channel-major int32)
    and return its manifest entry; its sha256 rides on channel 0's pass."""
    dtype, shape, nbytes, raw = _leaf_bytes(leaf)
    staging = staging_for(raw.device)
    mods = _all_moduli(codec)
    h = fingerprint_hasher(dtype, shape)
    with staging.context(), open(path, "wb") as f:
        limbs = _limbs(raw)
        n = limbs.numel()
        write_npy_header(f, "<i4", (len(mods), n))
        for c, m in enumerate(mods):
            for a in range(0, n, CHUNK):
                t0 = time.perf_counter()
                host = staging.to_host(_encode(limbs[a:a + CHUNK], m))
                t1 = time.perf_counter()
                f.write(memoryview(host))
                t2 = time.perf_counter()
                timings["encode_s"] += t1 - t0
                timings["write_s"] += t2 - t1
                if c == 0:
                    end = min(4 * (a + CHUNK), nbytes) - 4 * a
                    if end > 0:
                        h.update(memoryview(staging.to_host(
                            raw[4 * a:4 * a + end])))
                    timings["sha_s"] += time.perf_counter() - t2
        t0 = time.perf_counter()
        f.flush()
        os.fsync(f.fileno())
        _drop_cache(f)
        timings["write_s"] += time.perf_counter() - t0
        timings["bytes"] += f.tell()
    return {"dtype": dtype, "shape": list(shape), "nbytes": nbytes,
            "sha": h.hexdigest()[:32]}


def _timings() -> dict:
    return {"seconds": 0.0, "encode_s": 0.0, "write_s": 0.0, "sha_s": 0.0,
            "bytes": 0}


def write_step_dir(ckpt_dir: str, step: int, tree, *,
                   extra: dict | None = None,
                   timings: dict | None = None) -> str:
    """Atomic RRNS-format save of a tree: ``step_<N>/{manifest.json,
    0.rns.npy, ...}`` committed by fsync + rename.  ``timings``, when
    given, accumulates the seconds spent encoding (with the copies off the
    card), writing + fsyncing and hashing, and the bytes written."""
    t_start = time.perf_counter()
    timings = _timings() if timings is None else timings
    names, leaves, _ = _flatten(tree)
    codec = ckpt_codec()
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    stagings: dict = {}

    def staging(device):
        if device not in stagings:
            stagings[device] = _Staging(device)
        return stagings[device]

    metas = []
    for i, leaf in enumerate(leaves):
        metas.append(_write_leaf(os.path.join(tmp, f"{i}.rns.npy"), codec,
                                 leaf, staging, timings))
        _maybe_crash(step, i + 1)
    manifest = {
        "format": FORMAT,
        "step": step,
        "names": names,
        "leaves": metas,
        "codec": {
            "moduli": [int(m) for m in codec.base.moduli],
            "ma": int(codec.base.ma),
            "mb": int(codec.mb),
            "bits": int(codec.base.bits),
        },
        "extra": extra or {},
    }
    _write_fsync(os.path.join(tmp, "manifest.json"),
                 lambda f: f.write(json.dumps(manifest).encode()))
    commit_dir(tmp, final)
    timings["seconds"] += time.perf_counter() - t_start
    return final


def _read_manifest(path: str) -> dict:
    mp = os.path.join(path, "manifest.json")
    if not os.path.exists(mp):
        raise FileNotFoundError(f"no manifest under {path} (torn save?)")
    with open(mp) as f:
        return json.load(f)


class _Wire:
    """One ``i.rns.npy`` opened for reads of channel rows by column range,
    its header and size checked against the manifest."""

    def __init__(self, fp: str, n_channels: int, n_limbs: int,
                 mode: str = "rb"):
        if not os.path.exists(fp):
            raise FileNotFoundError(f"{fp} missing (torn save?)")
        self.f = open(fp, mode)
        try:
            version = np.lib.format.read_magic(self.f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(self.f)
            self.offset = self.f.tell()
            size = os.fstat(self.f.fileno()).st_size
        except Exception as e:  # truncated / mangled header
            self.f.close()
            raise CheckpointCorrupt(f"{fp} unloadable: {e}") from e
        self.n = n_limbs
        want = self.offset + 4 * n_channels * n_limbs
        if (shape != (n_channels, n_limbs) or fortran
                or dtype != np.dtype("<i4") or size != want):
            self.f.close()
            raise CheckpointCorrupt(
                f"{fp} holds {dtype} {shape} in {size} bytes, expected "
                f"int32 {(n_channels, n_limbs)} in {want} (truncated?)")

    def rows(self, channels, a: int, b: int) -> np.ndarray:
        out = np.empty((len(channels), b - a), dtype=np.int32)
        for i, c in enumerate(channels):
            self.f.seek(self.offset + 4 * (c * self.n + a))
            if self.f.readinto(memoryview(out[i]).cast("B")) != 4 * (b - a):
                raise CheckpointCorrupt(f"short read of {self.f.name}")
        return out

    def close(self):
        self.f.close()


def _read_leaf(wire: _Wire, codec: GradCodec, meta: dict, device, timings,
               out_device=None):
    """Decode one leaf's limbs on ``device`` into a buffer on
    ``out_device`` (``device`` when None): (int32 limbs, whether the
    content fingerprint matches).  The sha256 streams over the decoded
    bytes a chunk at a time."""
    moduli = tuple(int(m) for m in codec.base.moduli)
    base = tuple(range(len(moduli)))
    n, nbytes = wire.n, meta["nbytes"]
    out = torch.empty(n, dtype=torch.int32,
                      device=device if out_device is None else out_device)
    h = fingerprint_hasher(meta["dtype"], meta["shape"])
    for a in range(0, n, CHUNK):
        b = min(n, a + CHUNK)
        t0 = time.perf_counter()
        rows = torch.from_numpy(wire.rows(base, a, b)).to(device)
        t1 = time.perf_counter()
        out[a:b] = _decode(rows, moduli).to(out.device)
        t2 = time.perf_counter()
        h.update(memoryview(out[a:b].view(torch.uint8)[: nbytes - 4 * a]
                            .cpu().numpy()))
        t3 = time.perf_counter()
        timings["read_s"] += t1 - t0
        timings["decode_s"] += t2 - t1
        timings["sha_s"] += t3 - t2
    return out, h.hexdigest()[:32] == meta["sha"]


def _repair_leaf(wire: _Wire, codec: GradCodec, limbs, device) -> dict:
    """Find the elements whose five residues are not one codeword (the
    base channels' CRT value disagrees with a redundant channel), repair
    them with ``fault.repair_packed`` and patch their limbs in place.
    Returns the repair report; every other element is a codeword, which
    ``repair_packed`` would pass through untouched."""
    moduli = tuple(int(m) for m in codec.base.moduli)
    mods = _all_moduli(codec)
    nb = len(moduli)
    idx, cols = [], []
    for a in range(0, wire.n, CHUNK):
        b = min(wire.n, a + CHUNK)
        rows = torch.from_numpy(wire.rows(range(len(mods)), a, b)).to(device)
        d = _digits(rows[:nb], moduli)
        bad = torch.zeros(b - a, dtype=torch.bool, device=device)
        for c in range(nb, len(mods)):
            bad |= _value_mod(d, moduli, mods[c]) != rows[c]
        where = torch.nonzero(bad).flatten()
        idx.append(where + a)
        cols.append(rows[:, where])
    idx = torch.cat(idx)
    cols = torch.cat(cols, dim=1).cpu()
    if not idx.numel():
        return {"repaired": 0, "unrecoverable": 0}
    fixed, rep = repair_packed(codec, codec.as_array(cols, channel_major=True),
                               wraps=0)
    limbs[idx.to(limbs.device)] = _decode(
        fixed.residues[:nb].to(device), moduli).to(limbs.device)
    return rep


def _leaf_sha(leaf_limbs, meta) -> str:
    h = fingerprint_hasher(meta["dtype"], meta["shape"])
    h.update(memoryview(leaf_limbs.view(torch.uint8)[: meta["nbytes"]]
                        .cpu().numpy()))
    return h.hexdigest()[:32]


def read_step_dir(path: str, *, device=None, timings: dict | None = None,
                  decode_device=None):
    """Load + verify + repair one RRNS step dir.

    Returns ``(manifest, {name: tensor on device}, report)`` with ``report``
    counting ``{"leaves", "repaired_leaves", "repaired_elements",
    "unrecoverable"}``.  Raises FileNotFoundError for a torn save and
    CheckpointCorrupt when any leaf is beyond single-channel repair —
    callers fall back to the next restorable step.  ``timings``, when
    given, accumulates the seconds spent reading, decoding, hashing and
    repairing.  ``decode_device``, when given, runs the decode and the
    repair there while the leaves are gathered on ``device``.

    Legacy ``fault.load_step`` directories (plain ``.npy`` + sha
    fingerprints, no repair possible) are read transparently.
    """
    device = torch.device("cpu" if device is None else device)
    work = device if decode_device is None else torch.device(decode_device)
    timings = {} if timings is None else timings
    for k in ("read_s", "decode_s", "sha_s", "repair_s"):
        timings.setdefault(k, 0.0)
    manifest = _read_manifest(path)
    if manifest.get("format") != FORMAT:
        manifest, flat = load_step(path)
        flat = {k: as_tensor(v, device) for k, v in flat.items()}
        return manifest, flat, {"leaves": len(flat), "repaired_leaves": 0,
                                "repaired_elements": 0, "unrecoverable": 0}
    codec = codec_from_manifest(manifest)
    report = {"leaves": len(manifest["names"]), "repaired_leaves": 0,
              "repaired_elements": 0, "unrecoverable": 0}
    flat = {}
    for i, (name, meta) in enumerate(zip(manifest["names"],
                                         manifest["leaves"])):
        fp = os.path.join(path, f"{i}.rns.npy")
        wire = _Wire(fp, codec.n_channels, (meta["nbytes"] + 3) // 4)
        try:
            limbs, clean = _read_leaf(wire, codec, meta, work, timings,
                                      device)
            if not clean:
                t0 = time.perf_counter()
                rep = _repair_leaf(wire, codec, limbs, work)
                timings["repair_s"] += time.perf_counter() - t0
                if rep["unrecoverable"]:
                    report["unrecoverable"] += rep["unrecoverable"]
                    raise CheckpointCorrupt(
                        f"leaf {name!r} of {path}: {rep['unrecoverable']} "
                        f"element(s) with multi-channel damage — refusing "
                        f"(falling back beats miscorrecting)")
                if _leaf_sha(limbs, meta) != meta["sha"]:
                    raise CheckpointCorrupt(
                        f"leaf {name!r} of {path} fails its content "
                        f"fingerprint even after repair")
                report["repaired_leaves"] += 1
                report["repaired_elements"] += rep["repaired"]
        finally:
            wire.close()
        raw = limbs.view(torch.uint8)[: meta["nbytes"]]
        flat[name] = _bytes_as(raw, meta["dtype"], meta["shape"])
    return manifest, flat, report


def discover_steps(ckpt_dir: str) -> list[int]:
    """Committed step numbers under ``ckpt_dir``, ascending (``.tmp``
    remnants and non-checkpoint entries ignored)."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_", 1)[1]))
            except ValueError:
                continue
    return sorted(steps)


def discover_latest(ckpt_dir: str) -> int | None:
    """Newest committed step number (committed != verified: restore still
    walks backwards past corrupt steps)."""
    steps = discover_steps(ckpt_dir)
    return steps[-1] if steps else None


def inject_channel_corruption(path: str, *, leaf: int = 0,
                              channels=(0,), index: int = 0,
                              delta: int = 1) -> None:
    """Fault injection: modular-bump residues of one wire element in a
    committed step dir — each channel in ``channels`` moves by ``delta``
    mod its modulus, staying a syntactically valid residue.  One channel
    demonstrates locate-and-correct; two BASE channels (e.g. ``(0, 1)``)
    demonstrate the multi-channel refuse path.  The residues are patched
    in place: the file's bytes end as the reference's load-bump-save
    leaves them, without rewriting the file."""
    manifest = _read_manifest(path)
    codec = codec_from_manifest(manifest)
    mods = _all_moduli(codec)
    n = (manifest["leaves"][leaf]["nbytes"] + 3) // 4
    wire = _Wire(os.path.join(path, f"{leaf}.rns.npy"), len(mods), n,
                 mode="r+b")
    try:
        for c in channels:
            old = int(wire.rows((c,), index, index + 1)[0, 0])
            new = np.array([(old + delta) % mods[c]], dtype="<i4")
            wire.f.seek(wire.offset + 4 * (c * n + index))
            wire.f.write(new.tobytes())
        wire.f.flush()
        os.fsync(wire.f.fileno())
    finally:
        wire.close()


# ---------------------------------------------------------------------------
# the Checkpointer


def _snapshot(leaf):
    _refuse_dtensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return np.array(leaf, copy=True)


class Checkpointer:
    """Background-threaded, policy-driven, self-healing checkpoint writer.

    One writer thread consumes a bounded queue of snapshotted trees;
    ``maybe_save`` is the train-loop hook (cheap no-op when the policy is
    not due).  Writer errors surface on the next ``wait()`` / ``close()``
    / ``maybe_save()`` — a failed save can never vanish silently.  After
    every commit, retention GC prunes to the ``keep`` newest steps.
    ``saves`` records each committed save: its step, the ms its snapshot
    took on the caller's thread and the writer's ``write_step_dir``
    timings.

    Use as a context manager; ``close()`` drains the queue and joins the
    thread.
    """

    def __init__(self, ckpt_dir: str, policy="10", *, keep: int | None = None,
                 queue_size: int = 2):
        if keep is not None and keep < 1:
            raise ValueError("keep must be >= 1 (or None for no GC)")
        self.dir = ckpt_dir
        self.policy = parse_policy(policy)
        self.keep = keep
        self.saves: list[dict] = []
        os.makedirs(ckpt_dir, exist_ok=True)
        self._sweep_tmp()
        self._q: queue.Queue = queue.Queue(maxsize=max(1, queue_size))
        self._error: BaseException | None = None
        self._error_lock = threading.Lock()
        self._last_time = time.monotonic()
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ckpt-writer")
        self._thread.start()

    # -- lifecycle --------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _sweep_tmp(self) -> None:
        """Clear torn ``step_*.tmp`` remnants of a crashed predecessor
        (single-writer protocol: nothing else may be writing here)."""
        for d in os.listdir(self.dir):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, snap, extra, record = item
            item = None
            try:
                event = record.pop("event")
                if event is not None:
                    event.synchronize()
                write_step_dir(self.dir, step, snap, extra=extra,
                               timings=record)
                snap = None  # the snapshot's memory goes back now
                self._gc()
                self.saves.append(record)
            except BaseException as e:
                with self._error_lock:
                    if self._error is None:  # first failure wins
                        self._error = e
            finally:
                self._q.task_done()

    def _check_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    # -- saving -----------------------------------------------------------

    def maybe_save(self, step: int, tree, *, extra: dict | None = None,
                   force: bool = False) -> bool:
        """Save iff the policy says ``step`` (or the wall clock) is due.
        Returns True when a save was enqueued."""
        self._check_error()
        now = time.monotonic()
        if not (force or self.policy.step_due(step)
                or self.policy.time_due(now=now, last=self._last_time)):
            return False
        self._last_time = now
        self._enqueue(step, tree, extra)
        return True

    def save(self, step: int, tree, *, extra: dict | None = None) -> None:
        """Unconditional async save (policy bypassed)."""
        self._check_error()
        self._last_time = time.monotonic()
        self._enqueue(step, tree, extra)

    def _enqueue(self, step, tree, extra) -> None:
        if self._closed:
            raise RuntimeError("Checkpointer is closed")
        # snapshot NOW: the training loop may reuse these buffers the
        # moment we return.  A card's leaves are copied on the card (its
        # memory rate, not the host link's) and the writer waits for the
        # copies' event before it reads them.
        t0 = time.perf_counter()
        snap = _tree.tree_map(_snapshot, tree)
        leaves, _ = _tree.flatten(snap)
        event = None
        cuda = [x.device for x in leaves if isinstance(x, torch.Tensor)
                and x.device.type == "cuda"]
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(cuda[0]))
        record = dict(_timings(), step=step, event=event,
                      snapshot_ms=1e3 * (time.perf_counter() - t0))
        self._q.put((step, snap, extra, record))  # blocks when queue is full

    def wait(self) -> None:
        """Block until every enqueued save has committed; re-raise the
        first writer error if any save failed."""
        self._q.join()
        self._check_error()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._check_error()

    def _gc(self) -> None:
        if self.keep is None:
            return
        for s in discover_steps(self.dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------

    def restore(self, abstract_tree=None, shardings=None, *,
                step: int | None = None, device=None):
        return restore(self.dir, abstract_tree, shardings, step=step,
                       device=device)


def restore(ckpt_dir: str, abstract_tree=None, shardings=None, *,
            step: int | None = None, device=None,
            timings: dict | None = None):
    """Restore the newest repairable step (or exactly ``step``).

    Walks committed steps newest-first; a torn, truncated, or
    multi-channel-damaged step is SKIPPED (counted in the report) and the
    walk falls back to the next one.  Single-channel damage is repaired in
    stride via the RRNS codeword (``read_step_dir``).

    ``abstract_tree`` (a tree of tensors, ``meta`` ones included) fixes the
    structure; None rebuilds a nested dict from the saved ``a/b/c`` leaf
    names (dict-only trees).  Every leaf comes back as a tensor on
    ``device`` (the CPU when None), decoded there.  ``shardings``, a
    matching tree of ``dist.sharding.NamedSharding``s, places the leaves
    on the current mesh instead, which is what makes restore elastic: the
    step stores whole leaves, decoded on the mesh's device into host
    tensors, and each rank takes its slice (``dist.sharding.place_host``),
    so a ZeRO-1 state saved under one mesh reshards onto another.

    Returns ``(tree, step, extra, report)``; raises FileNotFoundError when
    nothing under ``ckpt_dir`` is restorable.
    """
    decode_device = None
    if shardings is not None:
        if abstract_tree is None or device is not None:
            raise ValueError("restore(shardings=) needs the abstract tree, "
                             "and no device=")
        decode_device = mesh_device(_tree.flatten(shardings)[0][0].mesh)
    candidates = ([step] if step is not None
                  else list(reversed(discover_steps(ckpt_dir))))
    skipped = 0
    last_err: Exception | None = None
    for s in candidates:
        path = os.path.join(ckpt_dir, f"step_{s}")
        try:
            manifest, flat, report = read_step_dir(
                path, device=device, timings=timings,
                decode_device=decode_device)
        except (FileNotFoundError, CheckpointCorrupt, OSError,
                ValueError, KeyError) as e:
            if step is not None:
                raise
            skipped += 1
            last_err = e
            continue
        report = dict(report, steps_skipped=skipped)
        if abstract_tree is None:
            tree = _nest(manifest["names"], flat)
        else:
            names, _, spec = _flatten(abstract_tree)
            if names != manifest["names"]:
                raise ValueError(
                    "checkpoint tree mismatch: "
                    f"{set(names) ^ set(manifest['names'])}")
            tree = _tree.unflatten(
                spec, [flat[k] for k in names] if shardings is None
                else place_leaves(names, flat, shardings, None))
        return tree, manifest["step"], manifest.get("extra", {}), report
    detail = f" (skipped {skipped}: {last_err})" if skipped else ""
    raise FileNotFoundError(
        f"no restorable checkpoint under {ckpt_dir}{detail}")


def _nest(names: list[str], flat: dict) -> dict:
    tree: dict = {}
    for name in names:
        parts = name.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = flat[name]
    return tree
