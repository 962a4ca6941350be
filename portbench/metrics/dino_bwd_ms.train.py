"""Device milliseconds per training step of the DINO tower's backward: the
operations launched inside the program's `backward.dino` span, from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("dino_bwd_ms.train")
