"""Device ms of the RRNS repair's mixed-radix conversions a step: the span
``rrns.mrc``, one conversion over each channel's survivors a repair pass
(``GradCodec._fault_scan``)."""
from portbench.span_ms import span_ms


def read(rec):
    return span_ms(rec, ("rrns.mrc",))
