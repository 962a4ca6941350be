"""The 95th percentile of every frame's latency in the window, from the
request to its bytes on the host, in milliseconds (host clock)."""
import numpy as np


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
