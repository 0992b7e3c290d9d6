"""The port's fault layer (``repro_torch.dist.fault``) against the
reference's ``repro.dist.fault``.

Fingerprints are compared as strings: the same data must hash the same in
both packages, bf16 included.  The ``load_*`` functions read step
directories written by the reference's ``train/checkpoint.save``.  The
RRNS store's verdicts, repairs and statistics must equal the reference's.

Tolerance: none.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro  # noqa: F401  (x64, as the reference's own tests run it)
from repro.dist import fault as rf
from repro.dist.grad_codec import GradCodec as RCodec
from repro.train import checkpoint as r_checkpoint
from repro_torch.dist import fault as tf
from repro_torch.dist._tree import flatten_named
from repro_torch.dist.grad_codec import GradCodec


def arrays(seed):
    """(jax, torch) pairs of one leaf each for several dtypes."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, size=(7,)).astype(np.int32)
    i64 = rng.integers(0, 1 << 40, size=(2, 2)).astype(np.int64)
    b = rng.standard_normal(4) > 0
    s = np.float32(rng.standard_normal())
    bf = rng.standard_normal((2, 3)).astype(np.float32)
    return {
        "f32": (jnp.asarray(f32), torch.from_numpy(f32)),
        "i32": (jnp.asarray(i32), torch.from_numpy(i32)),
        "i64": (jnp.asarray(i64), torch.from_numpy(i64)),
        "bool": (jnp.asarray(b), torch.from_numpy(b)),
        "scalar": (jnp.asarray(s), torch.tensor(s)),
        "bf16": (jnp.asarray(bf).astype(jnp.bfloat16),
                 torch.from_numpy(bf).to(torch.bfloat16)),
    }


@pytest.mark.parametrize("kind", ["f32", "i32", "i64", "bool", "scalar",
                                  "bf16"])
def test_tensor_fingerprint_equals_reference(kind):
    jx, tt = arrays(0)[kind]
    assert tf.tensor_fingerprint(tt) == rf.tensor_fingerprint(jx)
    assert tf.tensor_fingerprint(np.asarray(jx)) == rf.tensor_fingerprint(jx)
    if kind == "f32":  # a strided view hashes its values, in C order
        assert tf.tensor_fingerprint(tt.T) == rf.tensor_fingerprint(jx.T)


def trees(seed):
    a = arrays(seed)
    jt = {"zeta": a["f32"][0], "alpha": [a["i32"][0], (a["bf16"][0], None)],
          "mid": {"s": a["scalar"][0], "b": a["bool"][0]}}
    tt = {"zeta": a["f32"][1], "alpha": [a["i32"][1], (a["bf16"][1], None)],
          "mid": {"s": a["scalar"][1], "b": a["bool"][1]}}
    return jt, tt


def test_tree_fingerprints_names_and_order_equal_reference():
    jt, tt = trees(1)
    want = rf.tree_fingerprints(jt)
    got = tf.tree_fingerprints(tt)
    assert list(got.items()) == list(want.items())
    assert list(got) == ["alpha/[0]", "alpha/[1]/[0]", "mid/b", "mid/s",
                         "zeta"]
    assert [n for n, _ in flatten_named(tt)] == list(got)


def test_verify_fingerprints_reports_the_bad_leaves():
    jt, tt = trees(2)
    fps = rf.tree_fingerprints(jt)
    assert tf.verify_fingerprints(tt, fps) == []
    tt["zeta"] = tt["zeta"].clone()
    tt["zeta"][0, 0] += 1
    del fps["mid/s"]
    assert tf.verify_fingerprints(tt, fps) == ["mid/s", "zeta"]


def save_steps(ckpt_dir, seed):
    """Reference-written steps 1 to 3, then step 3 corrupted, plus a torn
    save (no manifest) at step 4."""
    rng = np.random.default_rng(seed)
    for step in (1, 2, 3):
        tree = {"params": {"w": jnp.asarray(rng.standard_normal((4, 3))
                                            .astype(np.float32)),
                           "b": jnp.asarray(rng.integers(0, 9, 5)
                                            .astype(np.int32))},
                "opt": [jnp.asarray(np.float32(step))]}
        r_checkpoint.save(str(ckpt_dir), step, tree, extra={"k": step})
    bad = os.path.join(ckpt_dir, "step_3", "0.npy")
    arr = np.load(bad)
    arr.flat[0] += 1
    np.save(bad, arr)
    os.makedirs(os.path.join(ckpt_dir, "step_4"))
    np.save(os.path.join(ckpt_dir, "step_4", "0.npy"), np.zeros(3))


def test_load_and_scan_reference_checkpoints(tmp_path):
    save_steps(tmp_path, seed=3)
    for step in (1, 2):
        path = str(tmp_path / f"step_{step}")
        m_t, flat_t = tf.load_step(path)
        m_r, flat_r = rf.load_step(path)
        assert m_t == m_r and list(flat_t) == list(flat_r)
        for k in flat_r:
            np.testing.assert_array_equal(flat_t[k], flat_r[k])
    with pytest.raises(IOError, match="corrupt"):
        tf.load_step(str(tmp_path / "step_3"))
    with pytest.raises(FileNotFoundError, match="torn"):
        tf.load_step(str(tmp_path / "step_4"))
    assert tf.load_verified(str(tmp_path / "step_3")) is None
    found_t, found_r = tf.scan_restorable(str(tmp_path)), \
        rf.scan_restorable(str(tmp_path))
    assert found_t[0] == found_r[0] == str(tmp_path / "step_2")
    assert found_t[1] == found_r[1]
    assert tf.find_restorable(str(tmp_path)) == str(tmp_path / "step_2")
    assert tf.find_restorable(str(tmp_path / "missing")) is None
    with open(tmp_path / "step_2" / "manifest.json") as f:
        assert json.load(f)["extra"] == {"k": 2}


def test_port_fingerprints_verify_a_reference_manifest(tmp_path):
    """A step the reference saved verifies against the port's tensors."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((5, 2)).astype(np.float32)
    r_checkpoint.save(str(tmp_path), 7, {"w": jnp.asarray(w),
                                         "n": [jnp.asarray(np.int32(3))]})
    with open(tmp_path / "step_7" / "manifest.json") as f:
        man = json.load(f)
    fps = dict(zip(man["names"], man["fingerprints"]))
    assert tf.verify_fingerprints({"w": torch.from_numpy(w),
                                   "n": [torch.tensor(3, dtype=torch.int32)]},
                                  fps) == []


def wire_pair(seed):
    rc, tc = RCodec.make(world=4, correct=True), \
        GradCodec.make(world=4, correct=True)
    g = np.random.default_rng(seed).standard_normal(257).astype(np.float32)
    return rc, tc, rc.encode_array(jnp.asarray(g), channel_major=True), \
        tc.encode_array(torch.from_numpy(g), channel_major=True)


def test_wire_store_matches_reference():
    rc, tc, ra, ta = wire_pair(5)
    rs, ts = rf.WireStore(rc), tf.WireStore(tc)
    for s, a in ((rs, ra), (ts, ta)):
        s.put("k", a)
        assert "k" in s and len(s) == 1 and list(s.keys()) == ["k"]
        assert s.matches("k", a) and s.ok("k")
        for ch in range(tc.n_channels):
            s.corrupt("k", channel=ch, delta=3 + ch, index=10 * ch + 1)
        assert not s.ok("k")
    np.testing.assert_array_equal(ts.get("k").residues.numpy(),
                                  np.asarray(rs.get("k").residues))
    assert ts.repair("k") == rs.repair("k") == {"repaired": tc.n_channels,
                                                 "unrecoverable": 0}
    np.testing.assert_array_equal(ts.get("k").residues.numpy(),
                                  ta.residues.numpy())
    assert ts.ok("k") and rs.ok("k")
    assert ts.matches("k", ta) and rs.matches("k", ra)
    for s in (rs, ts):  # two channels of one element: refused, not fixed
        s.corrupt("k", channel=0, delta=1, index=5)
        s.corrupt("k", channel=3, delta=2, index=5)
    assert ts.repair("k") == rs.repair("k") == {"repaired": 0,
                                                 "unrecoverable": 1}
    assert not ts.matches("k", ta) and not rs.matches("k", ra)
    assert ts.stats == rs.stats
    assert ts.pop("k") is not None and ts.pop("k") is None and len(ts) == 0
    ts.put("x", ta)
    ts.clear()
    assert len(ts) == 0


@pytest.mark.parametrize("channel_major", [False, True])
def test_repair_packed_raw_buffers_match_reference(channel_major):
    rc, tc, ra, ta = wire_pair(6)
    buf = np.array(ra.residues)                       # (nch, B) wire layout
    chans = tuple(rc.base.moduli) + rc.redundant
    bad = buf.copy()
    for c, m in enumerate(chans):
        bad[c, c::7] = (bad[c, c::7] + 2) % m
    if not channel_major:
        bad, buf = bad.T.copy(), buf.T.copy()
    got, rep = tf.repair_packed(tc, torch.from_numpy(bad),
                                channel_major=channel_major)
    want, rep_r = rf.repair_packed(rc, jnp.asarray(bad),
                                   channel_major=channel_major)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), buf)
    assert rep == rep_r and rep["unrecoverable"] == 0
    clean, rep = tf.repair_packed(tc, torch.from_numpy(buf),
                                  channel_major=channel_major)
    assert rep == {"repaired": 0, "unrecoverable": 0}
    np.testing.assert_array_equal(clean.numpy(), buf)
