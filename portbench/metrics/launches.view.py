"""Device kernels launched per served frame, from torch.profiler over the
frames of the profiled window."""


def read(rec):
    tr = rec.get("trace")
    return tr["kernels"] / tr["calls"] if tr else None
