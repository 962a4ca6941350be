"""Mean milliseconds per step of the training step's `render` stage, between
CUDA events recorded at the step's phase hook, over the window of the
traced run."""


def read(rec):
    return rec.get("render_ms")
