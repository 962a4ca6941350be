"""The whole training step's share of the card's float32 peak (67 TFLOP/s
at 700 W): the operations a step needs (counts.step_flops: the blends the
reference counts on the profiled steps forward and backward, the DINO term
from its widths, per splat its preprocess and Adam), averaged over the
profiled steps, over the window's mean step time."""
from portbench import common, counts


def read(rec):
    work = rec.get("work")
    if not work or not rec.get("steps"):
        return None
    flops = sum(counts.step_flops(w, rec["dino"], rec["height"], rec["width"], rec["active"],
                                  rec["params_per_splat"]) for w in work) / len(work)
    return 100.0 * flops / (rec["window_s"] / rec["steps"]) / common.PEAK_F32_FLOPS
