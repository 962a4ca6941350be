"""Percent of the profiled window in which no operation ran on the
device: 1 - the union of device operation intervals over the window."""


def read(rec):
    tr = rec.get("trace")
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"]) if tr else None
