"""Share of the traced window in which no kernel, memcpy or memset ran on
the device, in %: 100 (1 - busy / window)."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["window_us"])
