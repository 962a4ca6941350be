"""Percent of the binning's rectangle pairs that are live, per training
step: 100 times the program's counter `render.live_pairs` over
`render.rect_pairs`, from the window a traced run keeps with the program's
spans on (spans.traced)."""


def read(rec):
    return (rec.get("spans") or {}).get("metrics", {}).get("pair_yield.train")
