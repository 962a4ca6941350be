"""Device milliseconds per training step of the preprocess's backward: the
operations launched inside the program's `backward.preprocess` span and its
children (K8's VJP, on autograd's thread), from the window a traced run keeps
with the program's spans on (spans.traced). None where the program has no
such span."""


def read(rec):
    device = (rec.get("spans") or {}).get("device_ms") or {}
    ms = [v for k, v in device.items()
          if k == "backward.preprocess" or k.startswith("backward.preprocess.")]
    return sum(ms) if ms else None
