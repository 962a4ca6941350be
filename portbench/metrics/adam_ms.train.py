"""Mean milliseconds per step of the training step's `adam` stage, between
CUDA events recorded at the step's phase hook, over the window of the
traced run."""


def read(rec):
    return rec.get("adam_ms")
