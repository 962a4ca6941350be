"""torch.cuda.max_memory_allocated() from the moment the cell's inputs are
made (the splats, targets and weights held on the card) through the
system's set-up and the window, in GiB; left out on a device that reports
none."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec.get("peak_bytes") else None
