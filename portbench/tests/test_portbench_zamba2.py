"""The ``zamba2_7b`` configuration: its file against its own published
keys, the family's counts against the shapes, the two span readers, and
the cell run on the CPU at a small size of the published layout (its
small shape: ``portbench/conftest.py``).
"""
import json
import math
import time

import pytest

from conftest import ROOT, SMALL_TRAFFIC, small_model
from portbench import counts, harness
from portbench.families import hybrid
from portbench.span_ms import span_ms

CONF = json.loads((ROOT / "portbench" / "configs" /
                   "zamba2_7b.json").read_text())
CELL = "zamba2_7b.train_rns"


def test_the_file_keeps_the_published_keys_it_runs():
    m = CONF["model"]
    assert CONF["num_hidden_layers"] == m["n_layers"] == 12
    assert CONF["hybrid_layer_ids"] == m["hybrid_layer_ids"] == [6, 11]
    assert [i for i, t in enumerate(CONF["layers_block_type"])
            if t == "hybrid"] == m["hybrid_layer_ids"]
    assert len(CONF["layers_block_type"]) == m["n_layers"]
    pairs = {"hidden_size": "d_model", "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv",
             "attention_head_dim": "head_dim",
             "intermediate_size": "d_ff", "vocab_size": "vocab",
             "mamba_d_state": "ssm_state", "mamba_headdim": "ssm_headdim",
             "mamba_expand": "ssm_expand", "mamba_ngroups": "ssm_groups",
             "mamba_d_conv": "ssm_conv", "chunk_size": "ssm_chunk",
             "num_mem_blocks": "n_mem_blocks", "adapter_rank": "adapter_rank",
             "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta"}
    for key, port in pairs.items():
        assert CONF[key] == m[port], key
    assert CONF["attention_hidden_size"] == m["n_heads"] * m["head_dim"]
    assert CONF["n_mamba_heads"] * m["ssm_headdim"] == 2 * m["d_model"]
    assert CONF["hidden_act"] == "gelu" and m["act"] == "geglu_exact"
    assert set(CONF["reduced"]) == {"num_hidden_layers", "hybrid_layer_ids",
                                    "layers_block_type"}


def test_the_counts_of_the_cell():
    """1,757,853,120 parameters, 1,757,249,536 of them applied to a token
    as products (all but the norms, the conv and the SSD's vectors, with
    the tied embedding once, as the unembedding), and the sequence
    mixing's forward FLOPs a token at 4,096: twelve grouped SSDs and two
    causal attentions."""
    m = CONF["model"]
    assert sum(math.prod(s) for _, s, _ in hybrid.param_spec(m)) == (
        1_757_853_120)
    assert hybrid.matrix_params_applied(m) == 1_757_249_536
    ssd = 256 * (2 * 64 + 7168) + 4 * 64 * 7168
    attn = 2 * 4096 * 32 * 224
    assert hybrid.seq_flops_per_token(m, 4096) == 12 * ssd + 2 * attn
    assert counts.model_flops_per_step(hybrid, m, 2, 4096) == pytest.approx(
        9.029e13, rel=1e-3)


def test_one_group_counts_are_the_ssm_familys():
    m = dict(small_model("mamba2_370m"), ssm_groups=1, hybrid_layer_ids=[],
             d_ff=0, adapter_rank=0, n_heads=0, head_dim=0)
    assert hybrid._mamba_matrix_params(m) == counts.mamba_matrix_params(m)
    assert hybrid.seq_flops_per_token(m, 64) == pytest.approx(
        m["n_layers"] * counts.ssd_flops_per_token(m, 64))


@pytest.mark.parametrize("metric,names", [
    ("shared_block_ms", ("hybrid.shared", "hybrid.shared.bwd")),
    ("shared_attn_ms", ("hybrid.attn", "hybrid.attn.bwd"))])
def test_the_span_readers(metric, names):
    read = harness.load_plugin(ROOT, "metrics", metric).read
    span = {"host_us": 1.0, "device_us": 6000.0, "count": 2}
    rec = {"trace": {"steps": 3, "spans": {}, "host_spans": {
        names[0]: span, names[1]: dict(span, device_us=9000.0)}}}
    assert read(rec) == pytest.approx(5.0)
    assert read(rec) == span_ms(rec, names)
    # a program without the spans (the parent of this configuration)
    assert read({"trace": {"steps": 3, "spans": {}, "host_spans": {}}}) is None
    assert read({"trace": None}) is None


def test_the_traced_cell_runs_at_a_small_size():
    """In f32, where the gaps are rounding (the bf16 run is
    ``test_portbench_reference``'s), with the step's stage metrics; the
    span metrics read nothing off the card."""
    r = harness.run_cell(ROOT, CELL, 2**31 + 29, 0.0, True, "cpu",
                         time.perf_counter(),
                         model=small_model("zamba2_7b", dtype="float32"),
                         traffic=SMALL_TRAFFIC, log=lambda *a: None)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"fwd_bwd_ms", "codec_ms", "adamw_ms"} <= set(r["metrics"])
    assert not {"shared_block_ms", "shared_attn_ms"} & set(r["metrics"])
