"""The filter nodes' share of the HBM roofline, in %: the bytes of the
batches they take and yield (true lengths, each column byte once) over
3.35 TB/s, against their own device time."""


def read(run):
    return run.node_roofline("filter")
