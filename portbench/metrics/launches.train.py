"""Device kernels launched per training step, from torch.profiler over
the steps of the profiled window."""


def read(rec):
    tr = rec.get("trace")
    return tr["kernels"] / tr["calls"] if tr else None
