"""The aggregate nodes' share of the HBM roofline, in %: the bytes of the
key and value columns they take and of the result they yield, over
3.35 TB/s, against their own device time."""


def read(run):
    return run.node_roofline("aggregate")
