"""Training iterations per second: every step completed in the window,
over the window's seconds (the window ends with a synchronize)."""


def read(rec):
    return rec["steps"] / rec["window_s"] if "steps" in rec else None
