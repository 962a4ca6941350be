"""Mean milliseconds per step of the call to the DINO term (the render's
and the target's tower forwards and the cosine), between CUDA events
around the `dino_fn` that `train._build_dino_fn` returned, over the window
of the traced run."""


def read(rec):
    return rec.get("dino_fwd_ms")
