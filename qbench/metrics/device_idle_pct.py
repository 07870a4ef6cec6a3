"""The share, in %, of the profiled part of a traced window in which no
device operation runs: the union of the kernel, copy and memset intervals
in a ``torch.profiler`` trace against the window's span."""


def read(run):
    p = run.profile
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
