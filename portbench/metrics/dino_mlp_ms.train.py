"""Device milliseconds per training step of the DINO tower's MLP branches:
the operations launched inside every `losses.dino.*.mlp` span (each
block's norm, MLP products and activation, LayerScale and residual, in the
render's and the target's forwards), from the window a traced run keeps
with the program's spans on (spans.traced). None where the program has no
such span."""


def read(rec):
    device = (rec.get("spans") or {}).get("device_ms") or {}
    ms = [v for k, v in device.items() if k.startswith("losses.dino.") and k.endswith(".mlp")]
    return sum(ms) if ms else None
