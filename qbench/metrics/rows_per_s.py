"""Input rows of the queries completed in the window over the window's
seconds (host clock: the first submission to the last query's
synchronize). A db-benchmark query counts the table's rows, a TPC-H query
those of every table it reads."""


def read(run):
    return run.rows / run.window_s if run.window_s > 0 else None
