"""The DINO tower's share of the card's float32 peak (67 TFLOP/s at 700
W): the operations of the DINO term a step (the tower kind's term_flops:
the render's and the target's forwards and the backward to the render)
over the device seconds a step of the operations launched inside
`losses.dino.render`, `losses.dino.target` and `backward.dino`, their
children included, from the window a traced run keeps with the program's
spans on (spans.traced). None without those spans or the step's shape."""
from portbench import common, spans

TOWER_SPANS = ("losses.dino.render", "losses.dino.target", "backward.dino")


def read(rec):
    device = (rec.get("spans") or {}).get("device_ms")
    dino = rec.get("dino")
    if not device or not dino or "height" not in rec:
        return None
    ms = sum(spans.under(device, name) for name in TOWER_SPANS)
    if ms <= 0:
        return None
    flops = common.tower(dino).term_flops(dino, rec["height"], rec["width"])
    return 100.0 * flops / (ms * 1e-3) / common.PEAK_F32_FLOPS
