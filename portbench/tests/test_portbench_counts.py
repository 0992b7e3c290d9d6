"""The yardstick's counts against values worked out by hand from the
configuration's shapes."""
import json

from conftest import ROOT
from portbench import counts, harness


def _model(name):
    return json.loads((ROOT / "portbench" / "configs" /
                       f"{name}.json").read_text())["model"]


def _family(m):
    return harness.load_plugin(ROOT, "families", m["family"])


# mamba2-370m, d 1,024, d_inner 2,048, 32 heads, state 128, conv 4:
#   a layer: ln 1,024 + in_proj 1,024 x 4,384 = 4,489,216 + conv_w 4 x
#   2,304 = 9,216 + conv_b 2,304 + A_log, D, dt_bias 3 x 32 + norm 2,048 +
#   out_proj 2,048 x 1,024 = 2,097,152  ->  6,601,056;  x 48 = 316,850,688
#   embed 50,288 x 1,024 = 51,494,912, final_norm 1,024
ELEMENTS = 368_346_624
# matrices applied: 48 x (4,489,216 + 2,097,152) + 51,494,912
APPLIED = 367_640_576


def test_gradient_elements_and_codec_bytes():
    m = _model("mamba2_370m")
    assert counts.grad_elements(_family(m), m) == ELEMENTS
    n = ELEMENTS
    assert counts.encode_bytes(n, 4) == 20 * n      # 4 + 4 x 4 channels
    assert counts.encode_bytes(n, 5) == 24 * n      # the RRNS codec's 5
    assert counts.decode_bytes(n, 3) == 16 * n      # 3 base sums + f32


def test_matrix_parameters_applied():
    m = _model("mamba2_370m")
    assert _family(m).matrix_params_applied(m) == APPLIED


def test_mamba2_step_flops():
    m = _model("mamba2_370m")
    # SSD a token a layer at Q 256, n 128, h p 2,048:
    # 256 (128 + 2,048) + 4 x 128 x 2,048 = 557,056 + 1,048,576
    assert counts.ssd_flops_per_token(m, 2048) == 1_605_632
    # at a sequence shorter than the chunk, Q is the sequence: 64 x 2,176
    assert counts.ssd_flops_per_token(m, 64) == 139_264 + 1_048_576
    # 6 x 16,384 x 367,640,576 + 3 x 16,384 x 48 x 1,605,632
    assert counts.model_flops_per_step(_family(m), m, 8, 2048) == (
        36_140_539_183_104 + 3_788_161_155_072)


def test_peaks_are_the_data_sheet_ones():
    assert counts.PEAKS["bf16_flops"] == 989e12
    assert counts.PEAKS["hbm_bytes_per_s"] == 3.35e12
