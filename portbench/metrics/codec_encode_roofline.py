"""The codec encode kernel's share of its bandwidth roofline: the bytes an
encode of the gradient tree must move (4 + 4c an element, ``counts``) at
3.35 TB/s, over the ``codec_encode_kernel`` time a traced step."""
from portbench.counts import encode_bytes
from portbench.readers import roofline_pct


def read(rec):
    c = rec["counts"]
    if "channels" not in c:
        return None
    return roofline_pct(rec, "codec_encode_kernel",
                        encode_bytes(c["wire_elements"], c["channels"]))
