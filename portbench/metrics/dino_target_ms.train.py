"""Device milliseconds per training step of the DINO tower's no-grad
forward on the photo: the operations launched inside the program's
`losses.dino.target` span, from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("dino_target_ms.train")
