"""Tracing and metrics.

Reference: OpenTelemetry spans under ARROW_WITH_OPENTELEMETRY
(``util/tracing_internal.h:25-129``; ``START_COMPUTE_SPAN`` in kernels,
TracedNode in acero) and ad-hoc counters; the counterpart of the JAX
package's ``utils/tracing.py``.

``trace_span`` opens a ``torch.profiler.record_function`` range, which a
running ``torch.profiler`` records on the host timeline, and, when the
card is present, an NVTX range (``torch.cuda.nvtx``) that CUDA tools show
beside the kernels. A process-wide ``Metrics`` registry accumulates
per-operator calls / rows / seconds. ``start_profiler`` runs
``torch.profiler.profile`` (CPU and, with a card, CUDA activity) and
``stop_profiler`` writes its Chrome trace under ``ARROW_TPU_TRACE_DIR``
(the ARROW_TRACING_BACKEND analog).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional

__all__ = ["trace_span", "metrics", "Metrics", "start_profiler",
           "stop_profiler"]


class _Counter:
    __slots__ = ("calls", "rows", "seconds")

    def __init__(self):
        self.calls = 0
        self.rows = 0
        self.seconds = 0.0

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Per-operator counters (name -> calls / rows / wall seconds)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, _Counter] = {}

    def record(self, name: str, rows: int, seconds: float):
        with self._lock:
            c = self._counters.setdefault(name, _Counter())
            c.calls += 1
            c.rows += rows
            c.seconds += seconds

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: {"calls": c.calls, "rows": c.rows,
                        "seconds": round(c.seconds, 6),
                        "rows_per_sec": round(c.rows_per_sec, 1)}
                    for k, c in sorted(self._counters.items())}

    def reset(self):
        with self._lock:
            self._counters.clear()


metrics = Metrics()


def _nvtx():
    """``torch.cuda.nvtx`` where a card is present, else None."""
    import torch
    return torch.cuda.nvtx if torch.cuda.is_available() else None


@contextlib.contextmanager
def trace_span(name: str, rows: Optional[int] = None):
    """A span that ``torch.profiler`` records (and an NVTX range on a
    machine with a card); with ``rows``, its wall time and rows go into
    ``metrics``.

    The card's work is asynchronous: a kernel queued inside the span may
    still run after it closes, so the wall time measures what the host
    did (dispatch and the host reads it waited for) unless the caller
    synchronises; the engine's spans sit around blocking boundaries
    (materialization, host reads)."""
    import torch
    nvtx = _nvtx()
    t0 = time.perf_counter()
    if nvtx is not None:
        nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx is not None:
            nvtx.range_pop()
    if rows is not None:
        metrics.record(name, rows, time.perf_counter() - t0)


_profiler = None
_profiler_dir: Optional[str] = None


def start_profiler(log_dir: Optional[str] = None) -> Optional[str]:
    """Start ``torch.profiler.profile`` over the host and, with a card,
    the device; returns the trace directory, or None when none is set
    (``log_dir`` or ``ARROW_TPU_TRACE_DIR``) or a profile is running."""
    global _profiler, _profiler_dir
    import torch
    log_dir = log_dir or os.environ.get("ARROW_TPU_TRACE_DIR")
    if not log_dir or _profiler is not None:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _profiler, _profiler_dir = prof, log_dir
    return log_dir


def stop_profiler() -> Optional[str]:
    """Stop the profile ``start_profiler`` began and write its Chrome
    trace into the directory; returns the trace file's path (None when no
    profile runs)."""
    global _profiler, _profiler_dir
    if _profiler is None:
        return None
    prof, log_dir = _profiler, _profiler_dir
    _profiler = _profiler_dir = None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"arrow_tpu_torch.{os.getpid()}."
                        f"{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
    return path
