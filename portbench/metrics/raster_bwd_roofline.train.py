"""K2 (csrc/raster_bwd.cu) against its roofline: the least time the card
could take for the profiled steps' backward compositing (counts.k2_bound_s:
the blends the reference counts on each step's view and state, the visible
splats and the cotangent planes) over K2's device time in those steps."""
from portbench import counts, trace


def read(rec):
    tr, work = rec.get("trace"), rec.get("work")
    if not tr or not work:
        return None
    t = trace.kernel_seconds(tr, "raster_bwd_kernel")
    if t <= 0:
        return None
    return 100.0 * sum(counts.k2_bound_s(w, rec["pixels"]) for w in work) / t
