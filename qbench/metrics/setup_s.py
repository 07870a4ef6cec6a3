"""Seconds from the start of the harness's process to the first timed
query: imports, the kernels' build (a first run), generation and staging of
the tables, and the warm-up."""


def read(run):
    return run.setup_s
