"""The aggregate nodes' own device ms (CUDA events around each pull of
their streams, their inputs' time subtracted), a mean over the queries of
the instrumented part of a traced window."""


def read(run):
    return run.node_ms_per_query("aggregate")
