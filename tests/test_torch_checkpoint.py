"""The port's checkpointer (``repro_torch.train.checkpoint`` and
``repro_torch.train.checkpointer``), its drivers' resume path and the
serve engine's warm restart, against the reference's
(``tests/test_checkpointer.py`` and the checkpoint cases of
``tests/test_launchers.py``, mirrored on the port), and the two packages'
on-disk formats against each other.

Every comparison here is exact: the formats are lossless, so a step
directory written by either package holds byte-identical files for the same
tree and restores in the other with byte-equal leaves; a resumed run's
checkpoint equals an uninterrupted run's bit for bit (the port against
itself).  Inputs are drawn from numpy seeds; the models are the
``.smoke()`` configs on the CPU.
"""
import doctest
import filecmp
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.train import checkpoint as r_checkpoint
from repro.train import checkpointer as r_cp
from repro_torch.dist import _tree, fault
from repro_torch.train import checkpoint
from repro_torch.train import checkpointer as cp

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")

TRAIN_ARGS = ["--device", "cpu", "--arch", "gemma-2b", "--steps", "8",
              "--batch", "2", "--seq", "16", "--save-every", "4"]


def run_module(module, argv, tmp_path, **env):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable, "-m", module, *argv], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=600)


def bf16(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32).to(torch.bfloat16)


def raw(leaf) -> bytes:
    """A leaf's raw bytes, tensor (bf16 included) or numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def mixed_trees(seed=0):
    """The same leaves as a port tree (tensors) and a reference tree
    (numpy and jnp): f32, bf16, a 0-d int32 step, 3 and 5 bytes of
    uint8 (lengths that are not a multiple of 4) and an int64 row."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    h = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
    odd3 = rng.integers(0, 256, 3, dtype=np.uint8)
    odd5 = rng.integers(0, 256, 5, dtype=np.uint8)
    i64 = rng.integers(-(1 << 62), 1 << 62, 4, dtype=np.int64)
    ref = {"a": f32, "b": {"step": np.array(7, np.int32),
                           "h": jnp.asarray(h)},
           "odd": odd3, "odd5": odd5, "wide": i64}
    port = {"a": torch.from_numpy(f32.copy()),
            "b": {"step": torch.tensor(7, dtype=torch.int32),
                  "h": torch.from_numpy(h.view(np.int16).copy()).view(
                      torch.bfloat16)},
            "odd": torch.from_numpy(odd3.copy()),
            "odd5": torch.from_numpy(odd5.copy()),
            "wide": torch.from_numpy(i64.copy())}
    return port, ref


def same_files(a: Path, b: Path) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        assert filecmp.cmp(a / f, b / f, shallow=False), f


def assert_same_leaves(got: dict, want: dict) -> None:
    from repro_torch.dist._tree import flatten_named

    g, w = flatten_named(got), flatten_named(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, x), (_, y) in zip(g, w):
        assert tuple(x.shape) == tuple(np.shape(y)), name
        assert raw(x) == raw(y), name


# ------------------------------------------------------------ save policy
def test_parse_policy_overlapping_intervals():
    pol = cp.parse_policy("2@10,5,30s")
    due = [s for s in range(1, 21) if pol.step_due(s)]
    assert due == [2, 4, 6, 8, 10, 15, 20]  # dense early, sparse after
    assert pol.every_seconds == 30.0
    assert not pol.step_due(0)  # step 0 is the init state, never due


def test_policy_time_due_is_wall_clock_only():
    pol = cp.parse_policy("1m")
    assert not any(pol.step_due(s) for s in range(1, 200))
    assert pol.time_due(now=100.0, last=30.0)
    assert not pol.time_due(now=100.0, last=50.0)


@pytest.mark.parametrize("bad", ["0", "-1", "2@", "x", "3s,4s", "5,7"])
def test_parse_policy_rejects_malformed(bad):
    with pytest.raises(ValueError):
        cp.parse_policy(bad)
    with pytest.raises(ValueError):
        r_cp.parse_policy(bad)


@pytest.mark.parametrize("spec", ["2@10,5,30s", "1m", "3@4,7@20,9", "10"])
def test_parse_policy_matches_reference(spec):
    got, want = cp.parse_policy(spec), r_cp.parse_policy(spec)
    assert [(i.every, i.until) for i in got.intervals] == \
        [(i.every, i.until) for i in want.intervals]
    assert got.every_seconds == want.every_seconds
    assert [got.step_due(s) for s in range(60)] == \
        [want.step_due(s) for s in range(60)]


def test_checkpointer_doctests():
    res = doctest.testmod(cp, verbose=False)
    assert res.attempted > 0 and res.failed == 0


# ----------------------------------------------- lossless RRNS round trip
def test_write_read_round_trip_mixed_dtypes(tmp_path):
    tree, _ = mixed_trees()
    cp.write_step_dir(str(tmp_path), 5, tree, extra={"opt_step": 5})
    restored, step, extra, rep = cp.restore(str(tmp_path))
    assert (step, extra) == (5, {"opt_step": 5})
    assert rep["repaired_leaves"] == 0 and rep["steps_skipped"] == 0
    assert restored["b"]["step"].shape == ()  # 0-d stays 0-d
    assert restored["b"]["h"].dtype == torch.bfloat16
    assert_same_leaves(restored, tree)


def test_restore_into_an_abstract_tree_on_a_device(tmp_path):
    tree, _ = mixed_trees()
    cp.write_step_dir(str(tmp_path), 1, tree)
    abstract = {"a": torch.empty(3, 5, device="meta"),
                "b": {"step": torch.empty((), dtype=torch.int32),
                      "h": torch.empty(7, dtype=torch.bfloat16)},
                "odd": torch.empty(3, dtype=torch.uint8),
                "odd5": torch.empty(5, dtype=torch.uint8),
                "wide": torch.empty(4, dtype=torch.int64)}
    got, _, _, _ = cp.restore(str(tmp_path), abstract, device="cpu")
    assert got["a"].device == torch.device("cpu")
    assert_same_leaves(got, tree)
    with pytest.raises(ValueError, match="tree mismatch"):
        cp.restore(str(tmp_path), {"a": abstract["a"]})


def test_single_channel_corruption_repaired_on_restore(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    cp.write_step_dir(str(tmp_path), 1, tree)
    cp.inject_channel_corruption(str(tmp_path / "step_1"), leaf=0,
                                 channels=(2,), index=3)
    restored, step, _, rep = cp.restore(str(tmp_path))
    assert step == 1
    assert rep["repaired_leaves"] == 1 and rep["repaired_elements"] == 1
    assert torch.equal(restored["w"], tree["w"])  # exact rebuild


@pytest.mark.parametrize("channel", range(5))
def test_every_channel_repairs_like_the_reference(tmp_path, channel):
    """Damage in one channel of several elements: the port's report and
    leaf equal the reference's restore of the same damaged files."""
    port, ref = mixed_trees(channel)
    big = np.random.default_rng(9).standard_normal(300).astype(np.float32)
    port["big"], ref["big"] = torch.from_numpy(big.copy()), big
    cp.write_step_dir(str(tmp_path / "p"), 1, port)
    leaf = 3  # "big": a, b/h, b/step, big, ... in leaf order
    for index, delta in ((0, 1), (17, 5), (299, 32000)):
        cp.inject_channel_corruption(str(tmp_path / "p" / "step_1"),
                                     leaf=leaf, channels=(channel,),
                                     index=index, delta=delta)
    got, _, _, rep = cp.restore(str(tmp_path / "p"))
    want, _, _, rep_ref = r_cp.restore(str(tmp_path / "p"))
    assert rep == rep_ref
    # damage to a redundant channel leaves the content (decoded from the
    # base channels) intact: its fingerprint verifies and nothing repairs
    base = channel < cp.ckpt_codec().base.n
    assert (rep["repaired_leaves"], rep["repaired_elements"]) == \
        ((1, 3) if base else (0, 0))
    assert_same_leaves(got, want)
    assert_same_leaves(got, port)


def test_two_channel_damage_refused_with_fallback(tmp_path):
    cp.write_step_dir(str(tmp_path), 1, {"w": torch.ones(4)})
    cp.write_step_dir(str(tmp_path), 2, {"w": torch.full((4,), 2.0)})
    # two BASE channels of one element: beyond single-channel repair
    cp.inject_channel_corruption(str(tmp_path / "step_2"), channels=(0, 1))
    with pytest.raises(cp.CheckpointCorrupt):
        cp.restore(str(tmp_path), step=2)  # explicit step: refuse loudly
    with pytest.raises(r_cp.CheckpointCorrupt):
        r_cp.restore(str(tmp_path), step=2)  # and so does the reference
    restored, step, _, rep = cp.restore(str(tmp_path))
    assert step == 1 and rep["steps_skipped"] == 1  # fell back, counted
    assert torch.equal(restored["w"], torch.ones(4))


def test_truncated_wire_file_falls_back(tmp_path):
    cp.write_step_dir(str(tmp_path), 1, {"w": torch.ones(4)})
    cp.write_step_dir(str(tmp_path), 2, {"w": torch.zeros(4)})
    cp.write_step_dir(str(tmp_path), 3, {"w": torch.zeros(4)})
    f = tmp_path / "step_3" / "0.rns.npy"
    f.write_bytes(f.read_bytes()[:10])        # header cut
    g = tmp_path / "step_2" / "0.rns.npy"
    g.write_bytes(g.read_bytes()[:-4])        # body cut
    restored, step, _, rep = cp.restore(str(tmp_path))
    assert step == 1 and rep["steps_skipped"] == 2
    for s in (2, 3):
        with pytest.raises(cp.CheckpointCorrupt):
            cp.read_step_dir(str(tmp_path / f"step_{s}"))


def test_discover_ignores_tmp_and_foreign_entries(tmp_path):
    assert cp.discover_latest(str(tmp_path)) is None
    (tmp_path / "step_4.tmp").mkdir()
    (tmp_path / "step_abc").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert cp.discover_steps(str(tmp_path)) == []
    cp.write_step_dir(str(tmp_path), 10, {"a": torch.zeros(1)})
    cp.write_step_dir(str(tmp_path), 2, {"a": torch.zeros(1)})
    assert cp.discover_steps(str(tmp_path)) == [2, 10]
    assert cp.discover_latest(str(tmp_path)) == 10


def test_chunked_passes_give_the_same_bytes(tmp_path, monkeypatch):
    """The encode, decode and repair passes of a few limbs at a time write
    and read the same files as one pass over the leaf."""
    port, _ = mixed_trees(3)
    port["big"] = torch.from_numpy(
        np.random.default_rng(4).standard_normal(1001).astype(np.float32))
    cp.write_step_dir(str(tmp_path / "one"), 1, port)
    monkeypatch.setattr(cp, "CHUNK", 7)
    cp.write_step_dir(str(tmp_path / "many"), 1, port)
    same_files(tmp_path / "one" / "step_1", tmp_path / "many" / "step_1")
    cp.inject_channel_corruption(str(tmp_path / "many" / "step_1"), leaf=3,
                                 channels=(1,), index=500)
    got, _, _, rep = cp.restore(str(tmp_path / "many"))
    assert rep["repaired_elements"] == 1
    assert_same_leaves(got, port)


# ----------------------------------------------------- Checkpointer class
def test_checkpointer_policy_gc_and_tmp_sweep(tmp_path):
    (tmp_path / "step_7.tmp").mkdir()  # torn remnant of a "crash"
    tree = {"a": torch.arange(3, dtype=torch.float32)}
    with cp.Checkpointer(str(tmp_path), "2@4,3", keep=2) as saver:
        assert not (tmp_path / "step_7.tmp").exists()  # swept at init
        enq = [s for s in range(1, 10) if saver.maybe_save(s, tree)]
    assert enq == [2, 4, 6, 9]  # bounded interval first, then every 3
    assert cp.discover_steps(str(tmp_path)) == [6, 9]  # GC kept newest 2
    assert [s["step"] for s in saver.saves] == enq  # each save's timings
    restored, step, _, _ = cp.restore(str(tmp_path))
    assert step == 9
    assert torch.equal(restored["a"], tree["a"])


def test_checkpointer_snapshots_at_enqueue(tmp_path, monkeypatch):
    """The tree is copied before ``save`` returns: a leaf changed in
    place afterwards does not reach the file."""
    release, started = threading.Event(), threading.Event()
    real = cp.write_step_dir

    def slow(*a, **k):
        started.set()
        assert release.wait(10)
        return real(*a, **k)

    monkeypatch.setattr(cp, "write_step_dir", slow)
    leaf = torch.zeros(4)
    with cp.Checkpointer(str(tmp_path), "1") as saver:
        saver.save(1, {"a": leaf})
        assert started.wait(10)
        leaf.fill_(7.0)
        release.set()
    restored, _, _, _ = cp.restore(str(tmp_path))
    assert torch.equal(restored["a"], torch.zeros(4))


def test_checkpointer_worker_error_surfaces_on_wait(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(cp, "write_step_dir", boom)
    saver = cp.Checkpointer(str(tmp_path), "1")
    saver.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="disk full"):
        saver.wait()
    saver.close()  # error already consumed: close is clean


def test_checkpointer_worker_error_surfaces_on_close(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(cp, "write_step_dir", boom)
    saver = cp.Checkpointer(str(tmp_path), "1")
    saver.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="disk full"):
        saver.close()


# ------------------------------------------- legacy checkpoint satellites
def test_save_commits_atomically_no_tmp_left(tmp_path):
    path = checkpoint.save(str(tmp_path), 2, {"a": torch.arange(4)})
    assert os.path.basename(path) == "step_2"
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_save_async_error_reraised_on_join(tmp_path):
    target = tmp_path / "ck"
    target.write_text("a FILE where the ckpt dir should be")
    handle = checkpoint.save_async(str(target), 1, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        handle.join()


def test_save_async_same_step_guard(tmp_path, monkeypatch):
    release, started = threading.Event(), threading.Event()
    real_save = checkpoint.save

    def slow_save(*a, **k):
        started.set()
        assert release.wait(10)
        return real_save(*a, **k)

    monkeypatch.setattr(checkpoint, "save", slow_save)
    handle = checkpoint.save_async(str(tmp_path), 3, {"a": torch.zeros(2)})
    assert started.wait(10)
    with pytest.raises(RuntimeError, match="in flight"):
        checkpoint.save_async(str(tmp_path), 3, {"a": torch.zeros(2)})
    release.set()
    assert handle.join() == str(tmp_path / "step_3")
    # the guard clears with the thread: the same step saves again fine
    checkpoint.save_async(str(tmp_path), 3, {"a": torch.zeros(2)}).join()


def test_scan_restorable_edge_cases(tmp_path):
    # empty / missing dirs and non-checkpoint entries: None, no crash
    assert fault.scan_restorable(str(tmp_path)) is None
    assert fault.scan_restorable(str(tmp_path / "nope")) is None
    (tmp_path / "notes.txt").write_text("x")
    (tmp_path / "step_xyz").mkdir()
    assert fault.find_restorable(str(tmp_path)) is None

    checkpoint.save(str(tmp_path), 1, {"a": torch.arange(3)})
    # newest step loses a tensor file -> scan falls back one step
    checkpoint.save(str(tmp_path), 2, {"a": torch.arange(4)})
    os.remove(tmp_path / "step_2" / "0.npy")
    path, manifest, flat = fault.scan_restorable(str(tmp_path))
    assert path.endswith("step_1") and manifest["step"] == 1
    np.testing.assert_array_equal(flat["a"], np.arange(3))

    # torn save (no manifest with the fingerprints) -> skipped
    checkpoint.save(str(tmp_path), 3, {"a": torch.arange(5)})
    os.remove(tmp_path / "step_3" / "manifest.json")
    assert fault.find_restorable(str(tmp_path)).endswith("step_1")

    # bit rot under an intact manifest -> fingerprint mismatch, skipped
    checkpoint.save(str(tmp_path), 4, {"a": torch.arange(6)})
    rotten = np.load(tmp_path / "step_4" / "0.npy")
    rotten[0] ^= 1
    np.save(tmp_path / "step_4" / "0.npy", rotten)
    assert fault.find_restorable(str(tmp_path)).endswith("step_1")

    # a NEW-format (rrns-v1) dir is skipped cleanly by the legacy scanner
    cp.write_step_dir(str(tmp_path), 9, {"a": torch.arange(7)})
    assert fault.find_restorable(str(tmp_path)).endswith("step_1")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    tree, step, _ = checkpoint.restore(
        str(tmp_path), {"a": torch.empty(3, dtype=torch.int64)})
    assert step == 1 and torch.equal(tree["a"], torch.arange(3))


@pytest.mark.parametrize("restore", [cp.restore, checkpoint.restore],
                         ids=["checkpointer", "checkpoint"])
def test_restore_with_shardings_raises_naming_queue_1_item_4(tmp_path,
                                                             restore):
    """``restore(shardings=)``, the reference's elastic reshard onto a mesh
    (``test_elastic_restore_reshards_zero1_state``), on a (1, 1) CPU mesh:
    every leaf comes back a DTensor with the sharding's placements and the
    saved values, and passing ``device=`` as well is refused.  (Until the
    port had its sharding this call raised; the name is kept.)  Multi-rank
    reshards are in ``test_torch_mesh.py``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh

    made = not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    try:
        tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                "b": {"c": torch.arange(5)}}
        if restore is cp.restore:
            cp.write_step_dir(str(tmp_path), 1, tree)
        else:
            checkpoint.save(str(tmp_path), 1, tree)
        specs = {"a": sh.PartitionSpec("data", "model"),
                 "b": {"c": sh.PartitionSpec(None)}}
        shard = sh.named_shardings(specs, mesh)
        got = restore(str(tmp_path), tree, shard)
        assert got[1] == 1
        for (name, leaf), want, s in zip(_tree.flatten_named(got[0]),
                                         [tree["a"], tree["b"]["c"]],
                                         [shard["a"], shard["b"]["c"]]):
            assert isinstance(leaf, DTensor), name
            assert leaf.placements == s.placements
            assert torch.equal(leaf.full_tensor(), want)
        with pytest.raises(ValueError, match="device"):
            restore(str(tmp_path), tree, shard, device="cpu")
    finally:
        if made:
            dist.destroy_process_group()


# -------------------------------------------------- the two packages' bytes
def test_rrns_step_dir_byte_identical_to_reference(tmp_path):
    port, ref = mixed_trees()
    cp.write_step_dir(str(tmp_path / "p"), 5, port, extra={"opt_step": 5})
    r_cp.write_step_dir(str(tmp_path / "r"), 5, ref, extra={"opt_step": 5})
    same_files(tmp_path / "p" / "step_5", tmp_path / "r" / "step_5")
    with open(tmp_path / "p" / "step_5" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"][1]["dtype"] == "bfloat16"
    assert manifest["leaves"][2]["shape"] == []


def test_reference_written_step_restores_in_port(tmp_path):
    port, ref = mixed_trees(1)
    r_cp.write_step_dir(str(tmp_path), 3, ref, extra={"k": [1, 2]})
    r_cp.inject_channel_corruption(str(tmp_path / "step_3"), leaf=0,
                                   channels=(2,), index=2)
    got, step, extra, rep = cp.restore(str(tmp_path))
    assert (step, extra, rep["repaired_leaves"]) == (3, {"k": [1, 2]}, 1)
    assert_same_leaves(got, port)


def test_port_written_step_restores_in_reference(tmp_path):
    port, ref = mixed_trees(2)
    cp.write_step_dir(str(tmp_path), 4, port)
    cp.inject_channel_corruption(str(tmp_path / "step_4"), leaf=4,
                                 channels=(0,), index=1)
    got, step, _, rep = r_cp.restore(str(tmp_path))
    assert step == 4 and rep["repaired_leaves"] == 1
    assert_same_leaves(got, ref)


def test_inject_matches_the_reference_bytes(tmp_path):
    port, _ = mixed_trees(5)
    for d in ("p", "r"):
        cp.write_step_dir(str(tmp_path / d), 1, port)
    cp.inject_channel_corruption(str(tmp_path / "p" / "step_1"), leaf=0,
                                 channels=(0, 4), index=9, delta=77)
    r_cp.inject_channel_corruption(str(tmp_path / "r" / "step_1"), leaf=0,
                                   channels=(0, 4), index=9, delta=77)
    same_files(tmp_path / "p" / "step_1", tmp_path / "r" / "step_1")


def test_legacy_step_dir_byte_identical_and_cross_restores(tmp_path):
    """``checkpoint.save``'s format.  bf16 is left out: the reference
    writes it as numpy ``<V2`` records that neither package reads back as
    bf16 (its own restore of them fails the fingerprint)."""
    port, ref = mixed_trees(6)
    for tree in (port, ref):
        tree["b"].pop("h")
    checkpoint.save(str(tmp_path / "p"), 2, port, extra={"e": 1})
    r_checkpoint.save(str(tmp_path / "r"), 2, ref, extra={"e": 1})
    same_files(tmp_path / "p" / "step_2", tmp_path / "r" / "step_2")
    got, step, extra = checkpoint.restore(str(tmp_path / "r"), port)
    assert (step, extra) == (2, {"e": 1})
    assert_same_leaves(got, port)
    want, _, _ = r_checkpoint.restore(str(tmp_path / "p"), ref)
    assert_same_leaves(port, want)
    # the rrns reader reads a legacy step too
    tree, step, _, rep = cp.restore(str(tmp_path / "p"))
    assert step == 2 and rep["leaves"] == 5
    assert_same_leaves(tree, port)


def test_legacy_bf16_leaf_bytes_match_reference(tmp_path):
    checkpoint.save(str(tmp_path / "p"), 1, {"h": bf16([1.5, -2.0, 3.25])})
    r_checkpoint.save(str(tmp_path / "r"), 1, {"h": jnp.asarray(
        [1.5, -2.0, 3.25], jnp.bfloat16)})
    same_files(tmp_path / "p" / "step_1", tmp_path / "r" / "step_1")


def corner_words(codec) -> np.ndarray:
    words = [0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    for m in tuple(codec.base.moduli) + codec.redundant:
        words += [m - 1, m, m + 1, 2 * m - 1, m * m - 1, m * m, m * m + 1]
    return np.array(words, dtype=np.uint64).astype(np.uint32)


def test_leaf_wire_exact_against_reference_on_corner_words():
    codec, r_codec = cp.ckpt_codec(), r_cp.ckpt_codec()
    assert tuple(codec.base.moduli) == tuple(r_codec.base.moduli)
    assert codec.redundant == r_codec.redundant
    words = corner_words(codec)
    wire = cp.leaf_to_wire(codec, words)
    want = r_cp.leaf_to_wire(r_codec, words)
    assert wire.dtype == np.int32 and np.array_equal(wire, want)
    back = cp.wire_to_leaf(codec, wire, "uint32", words.shape, words.nbytes)
    assert raw(back) == words.tobytes()
    # any residues, codewords or not: the same low word as the reference
    rng = np.random.default_rng(11)
    mods = np.array(tuple(codec.base.moduli) + codec.redundant)
    noise = (rng.integers(0, 1 << 30, (5, 4096)) % mods[:, None]).astype(
        np.int32)
    for w in (noise, wire):
        got = cp.wire_to_leaf(codec, w, "uint32", (w.shape[1],),
                              4 * w.shape[1])
        assert raw(got) == r_cp.wire_to_leaf(
            r_codec, w, "uint32", (w.shape[1],), 4 * w.shape[1]).tobytes()


# ------------------------------------------------- kill-and-resume chaos
def _leaf_shas(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return [leaf["sha"] for leaf in json.load(f)["leaves"]]


def test_sigkill_mid_save_then_resume_bitwise_equal(tmp_path, capsys):
    """SIGKILL lands inside the background writer after the first leaf
    file of step_8: the torn .tmp never commits, step_4 survives, and the
    resumed trainer re-runs 4..8 to a checkpoint bitwise-identical to an
    uninterrupted run's."""
    from repro_torch.launch.train import main as train_main

    ref, ck = str(tmp_path / "ref"), str(tmp_path / "ck")
    train_main(TRAIN_ARGS + ["--ckpt-dir", ref])  # uninterrupted baseline

    out = run_module("repro_torch.launch.train", TRAIN_ARGS
                     + ["--ckpt-dir", ck], tmp_path,
                     **{cp.CRASH_STEP_ENV: "8"})
    assert out.returncode == -signal.SIGKILL, out.stderr[-2000:]
    names = os.listdir(ck)
    assert "step_8.tmp" in names and "step_8" not in names  # torn, by design
    assert "step_4" in names  # the committed survivor

    capsys.readouterr()
    train_main(TRAIN_ARGS + ["--ckpt-dir", ck])  # resume 4 -> 8
    log = capsys.readouterr().out
    assert "[resume] restored step 4" in log
    assert not os.path.exists(os.path.join(ck, "step_8.tmp"))  # swept
    assert _leaf_shas(os.path.join(ck, "step_8")) == \
        _leaf_shas(os.path.join(ref, "step_8"))  # bitwise-equal resume


def test_resume_repairs_single_channel_and_refuses_two(tmp_path, capsys):
    """The driver's --inject-ckpt-corrupt path: 1 channel is repaired in
    stride and logged; 2 base channels force fallback to the prior step."""
    from repro_torch.launch.train import main as train_main

    ck = str(tmp_path / "ck")
    train_main(TRAIN_ARGS + ["--ckpt-dir", ck])
    capsys.readouterr()
    _, summary = train_main(TRAIN_ARGS + ["--ckpt-dir", ck,
                                          "--inject-ckpt-corrupt", "1"])
    log = capsys.readouterr().out
    assert "[inject] corrupted 1 RRNS channel(s) of step 8, leaf 0, " \
        "element 0" in log
    assert "repaired_leaves=1" in log and "restored step 8" in log
    assert summary["start_step"] == 8 and summary["losses"] == []
    assert log.strip().splitlines()[-1] == json.dumps(summary)
    train_main(TRAIN_ARGS + ["--ckpt-dir", ck, "--inject-ckpt-corrupt", "2"])
    log = capsys.readouterr().out
    assert "restored step 4" in log and "steps_skipped=1" in log


def test_train_driver_resumes_exactly(tmp_path):
    from repro_torch.launch.train import main as train_main

    ck = str(tmp_path / "ck")
    _, first = train_main(TRAIN_ARGS + ["--ckpt-dir", ck])
    # second run resumes from step 8's checkpoint and continues
    _, second = train_main(TRAIN_ARGS[:5] + ["10"] + TRAIN_ARGS[6:]
                           + ["--ckpt-dir", ck])
    steps = sorted(d for d in os.listdir(ck) if d.startswith("step_"))
    assert "step_8" in steps
    assert second["start_step"] == 8 and len(second["losses"]) == 2
    assert [s["step"] for s in first["ckpt_saves"]] == [4, 8]
    assert second["restored"]["repaired_leaves"] == 0


def test_inject_needs_a_ckpt_dir():
    from repro_torch.launch.train import main as train_main

    with pytest.raises(SystemExit):
        train_main(["--device", "cpu", "--inject-ckpt-corrupt", "1"])


# ---------------------------------------------------- warm serve restart
@pytest.fixture(scope="module")
def scfg():
    from repro_torch.configs import get_config

    return get_config("gemma-2b").smoke()


@pytest.fixture(scope="module")
def sparams(scfg):
    from repro_torch.models import init_params

    return init_params(scfg, 0, "cpu")


def _serve_engine(scfg, sparams, **kw):
    from repro_torch.serve.batcher import ContinuousBatcher

    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", 32)
    kw.setdefault("prefill_chunk", 8)
    kw.setdefault("page_size", 8)
    kw.setdefault("rns_verify", True)
    return ContinuousBatcher(scfg, sparams, **kw)


def _shared_prefix_reqs(scfg, seed=5):
    from repro_torch.serve.scheduler import Request

    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, scfg.vocab, 8)]
    return prefix, [Request(rid=i, prompt=prefix + [30 + i], max_new=3)
                    for i in range(2)]


def test_warm_restart_adopts_pages_bitwise(tmp_path, scfg, sparams):
    from repro_torch.serve.scheduler import Request

    prefix, reqs = _shared_prefix_reqs(scfg)
    eng = _serve_engine(scfg, sparams)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    saved = eng.save_warm_state(str(tmp_path))
    assert saved["pages_saved"] >= 1  # the retained shared-prefix chain

    fresh = _serve_engine(scfg, sparams)
    rep = fresh.load_warm_state(str(tmp_path))
    assert rep["adopted"] == saved["pages_saved"]
    assert rep["dropped"] == 0 and rep["repaired_pages"] == 0
    for n in ("k", "v"):
        assert torch.equal(fresh.cache[n], eng.cache[n])

    # the adopted pages dedup a new same-prefix request after the restart
    fresh.submit(Request(rid="new", prompt=prefix + [9], max_new=3))
    done = fresh.run_to_completion()
    assert fresh.page_stats()["dedup_hits"] >= 1
    assert fresh.verify_log["new"] is True  # retirement re-verify passes

    cold = _serve_engine(scfg, sparams)  # bitwise vs a cold engine
    cold.submit(Request(rid="new", prompt=prefix + [9], max_new=3))
    cdone = cold.run_to_completion()
    assert [r.out for r in done] == [r.out for r in cdone]
    with pytest.raises(RuntimeError, match="fresh engine"):
        fresh.load_warm_state(str(tmp_path))


def test_warm_restart_repairs_corrupted_state_file(tmp_path, scfg, sparams):
    _, reqs = _shared_prefix_reqs(scfg)
    eng = _serve_engine(scfg, sparams)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    saved = eng.save_warm_state(str(tmp_path))
    # one RRNS channel of one saved leaf rots on disk
    cp.inject_channel_corruption(str(tmp_path / "step_0"), leaf=0,
                                 channels=(2,))
    fresh = _serve_engine(scfg, sparams)
    rep = fresh.load_warm_state(str(tmp_path))
    assert rep["ckpt_repaired_leaves"] == 1  # fixed at the checkpoint layer
    assert rep["adopted"] == saved["pages_saved"] and rep["dropped"] == 0


def test_warm_restart_drops_unrepairable_page(tmp_path, scfg, sparams):
    """A stored page codeword rotten in TWO base channels round-trips
    losslessly through the checkpoint, fails revalidation on load, and the
    page (with any descendants) is dropped instead of trusted."""
    _, reqs = _shared_prefix_reqs(scfg)
    eng = _serve_engine(scfg, sparams)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    retained = list(eng.sched.alloc.retained)
    assert retained
    eng.corrupt_wire(retained[0], channel=0, delta=3)
    eng.corrupt_wire(retained[0], channel=1, delta=3)
    saved = eng.save_warm_state(str(tmp_path))
    fresh = _serve_engine(scfg, sparams)
    rep = fresh.load_warm_state(str(tmp_path))
    assert rep["dropped"] >= 1
    assert rep["adopted"] == saved["pages_saved"] - rep["dropped"]


def test_warm_restart_refusals(tmp_path, scfg, sparams):
    _, reqs = _shared_prefix_reqs(scfg)
    eng = _serve_engine(scfg, sparams)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    eng.save_warm_state(str(tmp_path))
    with pytest.raises(RuntimeError, match="warm restart needs"):
        _serve_engine(scfg, sparams, rns_verify=False).load_warm_state(
            str(tmp_path))
    with pytest.raises(ValueError, match="geometry"):
        _serve_engine(scfg, sparams, n_pages=12).load_warm_state(
            str(tmp_path))
    other = {k: v + 1 if k == "final_norm" else v
             for k, v in sparams.items()}
    with pytest.raises(ValueError, match="different params"):
        _serve_engine(scfg, other).load_warm_state(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _serve_engine(scfg, sparams).load_warm_state(str(tmp_path / "none"))


# ------------------------------------------------------------- train_e2e
def test_train_e2e_short_run_learns_and_its_checkpoint_restores(tmp_path):
    """The example at 20 of its 300 steps (the card runs all 300 and holds
    the final loss under 3.0): the loss falls, and step 20's legacy
    checkpoint restores byte-equal to the returned state."""
    from repro_torch import train_e2e

    r = train_e2e.main("cpu", steps=20, ckpt_dir=str(tmp_path), save_every=10,
                       verbose=False)
    assert r["n_params"] == 15_735_168
    assert len(r["losses"]) == 20 and r["losses"][-1] < r["losses"][0] - 0.2
    assert [os.path.basename(p) for p in r["checkpoints"]] == \
        ["step_10", "step_20"]
    state = {"params": r["params"], "opt": r["opt"]}
    tree, step, _ = checkpoint.restore(str(tmp_path), state)
    assert step == 20
    assert_same_leaves(tree, state)
