"""Mean milliseconds per step of the training step's `backward` stage, between
CUDA events recorded at the step's phase hook, over the window of the
traced run."""


def read(rec):
    return rec.get("backward_ms")
