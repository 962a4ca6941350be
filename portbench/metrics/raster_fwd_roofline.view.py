"""K1 (csrc/raster_fwd.cu) against its roofline: the least time the card
could take for the profiled frames' compositing (counts.k1_bound_s: the
blends the reference counts on each frame, the visible splats and the
output planes) over K1's device time in those frames."""
from portbench import counts, trace


def read(rec):
    tr, work = rec.get("trace"), rec.get("work")
    if not tr or not work:
        return None
    t = trace.kernel_seconds(tr, "raster_fwd_kernel")
    if t <= 0:
        return None
    return 100.0 * sum(counts.k1_bound_s(w, rec["pixels"]) for w in work) / t
