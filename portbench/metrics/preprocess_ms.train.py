"""Device milliseconds per training step of the operations launched inside
the program's `render.preprocess` spans (the activations, `preprocess`,
`build_blob`), from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("preprocess_ms.train")
