"""Kernel launches a step: kernel events in the profiler trace of the
traced steps, over their number (memcpy and memset not counted)."""


def read(rec):
    tr = rec["trace"]
    return tr["launches"] / tr["steps"] if tr and tr["launches"] else None
