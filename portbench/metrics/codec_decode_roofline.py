"""The codec decode kernel's share of its bandwidth roofline: the bytes a
decode of the summed wire must move (the base channels read, one f32
written: 4b + 4 an element, ``counts``) at 3.35 TB/s, over the
``codec_decode_kernel`` time a traced step."""
from portbench.counts import decode_bytes
from portbench.readers import roofline_pct


def read(rec):
    c = rec["counts"]
    if "base_channels" not in c:
        return None
    return roofline_pct(rec, "codec_decode_kernel",
                        decode_bytes(c["wire_elements"], c["base_channels"]))
