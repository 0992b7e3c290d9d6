"""The whole step's share of the card's bf16 peak, in %, on the device's
own clock: the model FLOPs of the steps traced on the device alone
(``counts.model_flops_per_step``: 6 T P plus the sequence mixing's terms,
no recomputation) over the device's span of them, first kernel start to
last kernel end, idle stretches between included, and 989e12."""


def read(rec):
    tr = rec["trace"]
    if not tr or not tr["launches"] or tr["device_span_us"] <= 0:
        return None
    flops = rec["counts"]["model_flops_per_step"] * tr["steps"]
    return (100.0 * flops / (tr["device_span_us"] / 1e6)
            / rec["peaks"]["bf16_flops"])
