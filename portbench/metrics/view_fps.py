"""Frames per second: every frame whose bytes reached the host in the
window, over the window's seconds."""


def read(rec):
    return rec["frames"] / rec["window_s"] if "frames" in rec else None
