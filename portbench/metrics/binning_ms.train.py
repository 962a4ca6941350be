"""Device milliseconds per training step of the operations launched inside
the program's `render.binning` spans and their children (the pair
expansion, the sort, the tile ranges), from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("binning_ms.train")
