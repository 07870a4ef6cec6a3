"""The hash-join nodes' own device ms, summed over a query's joins, a mean
over the queries of the instrumented part of a traced window."""


def read(run):
    return run.node_ms_per_query("hashjoin")
