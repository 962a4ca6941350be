"""Seconds from the start of the process to the start of the window:
imports, inputs made from the seed, the system's set-up, kernel builds and
the warm-up calls."""


def read(rec):
    return rec["setup_s"]
