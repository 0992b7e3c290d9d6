"""Host ms of one call into the step driver, no synchronize added: the
mean over the timed window's steps (the benchmark's host clock)."""


def read(rec):
    ms = rec["host_call_ms"]
    return sum(ms) / len(ms) if ms else None
