"""Device milliseconds per served frame of the operations launched inside
the program's `render.preprocess` span (K6), from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("preprocess_ms.view")
