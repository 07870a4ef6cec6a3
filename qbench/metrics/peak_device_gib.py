"""``torch.cuda.max_memory_allocated()`` over the window, tables included
(the peak statistics are reset as the window opens), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
