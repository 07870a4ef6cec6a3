"""Synchronising CUDA operations a query makes (host reads, pageable
copies, stream synchronisations), counted by torch's sync debug mode over
the instrumented part of a traced window, a mean over its queries."""


def read(run):
    counted = [q["syncs"] for q in run.queries]
    return sum(counted) / len(counted) if counted else None
