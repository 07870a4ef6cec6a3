"""What a ``--trace 1`` run records, by methods frozen here.

- ``NodeTrace``: every plan node class's ``batches()`` wrapped so that each
  ``next()`` of a node's stream is bracketed by two CUDA events (it includes
  the work of the node's inputs, pulled inside it); a node's own time is its
  time less its inputs'. Each batch a node yields is counted in bytes at its
  true length: every column's values once, a string column's offsets and
  used pool bytes, a validity byte a row. The method of the port's
  ``profile_step.node_layers``, copied so that a change to the program
  cannot move it.
- ``count_syncs``: the synchronising CUDA operations a call makes, counted
  by torch's sync debug mode (a warning at each device-to-host copy,
  ``item``, ``nonzero``, stream synchronisation), as ``chip_smoke.py``'s
  ``counted_syncs`` does.
- ``device_profile``: from a ``torch.profiler`` trace of a window, the union
  of the device's operation intervals (kernels, copies, memsets) against the
  window's span, the operations that took most time, and the longest idle
  gaps named by the host operation running when each began.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings
from collections import defaultdict

import torch


class _HostEvent:
    """A host-clock stand-in for a CUDA event, for runs on the CPU (the
    harness's own tests): never a device time."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


def _event(device):
    if device.type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def _batch_size(b):
    """(fixed bytes a row, the batch's length, offsets of its string
    columns): resolved after the query, so that counting reads nothing on
    the host meanwhile."""
    per_row, offsets = 0, []
    for a in b.arrays:
        if a.offsets is not None and a.dictionary is None:
            per_row += 4
            offsets.append(a.offsets)
        else:
            per_row += a.values.element_size() * math.prod(
                a.values.shape[1:])
        if a.validity is not None:
            per_row += 1
    return per_row, b.length, offsets


def _resolve_bytes(sizes) -> int:
    total = 0
    for per_row, length, offsets in sizes:
        n = int(length)
        total += per_row * n
        for off in offsets:
            total += int(off[n]) - int(off[0])
    return total


class NodeTrace:
    """Own device ms and bytes of each plan node of each query."""

    def __init__(self, nodes_module, device):
        self.nodes = nodes_module
        self.device = device
        self._undo = []
        self._reset()

    def _reset(self):
        self.spans = defaultdict(list)
        self.sizes = defaultdict(list)
        self.children = {}
        self.factory = {}
        self.labels = {}

    def _label(self, node) -> str:
        if id(node) not in self.labels:
            name = node.factory_name
            k = sum(lab.startswith(name + "#") for lab in self.labels.values())
            self.labels[id(node)] = f"{name}#{k}"
            self.factory[self.labels[id(node)]] = name
        return self.labels[id(node)]

    def install(self):
        """Wrap each node class's ``batches`` once (a class that inherits a
        wrapped one is left as it is)."""
        trace = self
        for cls in set(self.nodes.FACTORIES.values()):
            inner = cls.batches
            if getattr(inner, "_qbench_wrapped", False):
                continue
            self._undo.append((cls, cls.__dict__.get("batches")))

            def batches(node, _inner=inner):
                lab = trace._label(node)
                trace.children[lab] = [trace._label(c) for c in node.inputs]
                it = _inner(node)
                while True:
                    start, end = _event(trace.device), _event(trace.device)
                    start.record()
                    try:
                        b = next(it)
                    except StopIteration:
                        return
                    finally:
                        end.record()
                        trace.spans[lab].append((start, end))
                    trace.sizes[lab].append(_batch_size(b))
                    yield b
            batches._qbench_wrapped = True
            cls.batches = batches

    def remove(self):
        for cls, own in reversed(self._undo):
            if own is None:
                del cls.batches
            else:
                cls.batches = own
        self._undo = []

    def take(self) -> list:
        """The nodes of the query just run (call after its synchronize):
        ``[{"node", "factory", "own_ms", "in_bytes", "out_bytes"}]``."""
        inclusive = {lab: sum(s.elapsed_time(e) for s, e in evs)
                     for lab, evs in self.spans.items()}
        out_bytes = {lab: _resolve_bytes(sz) for lab, sz in self.sizes.items()}
        rows = []
        for lab, ms in inclusive.items():
            kids = self.children.get(lab, [])
            rows.append({"node": lab, "factory": self.factory[lab],
                         "own_ms": ms - sum(inclusive.get(c, 0.0)
                                            for c in kids),
                         "in_bytes": sum(out_bytes.get(c, 0) for c in kids),
                         "out_bytes": out_bytes.get(lab, 0)})
        self._reset()
        return rows


@contextlib.contextmanager
def count_syncs(device):
    """Counts, into the yielded list's one element, the synchronising CUDA
    operations made inside the block (nothing on the CPU)."""
    counted = [0]
    if device.type != "cuda":
        yield counted
        return
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counted
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted[0] = sum("synchroniz" in str(w.message) for w in seen)


WINDOW_LABEL = "qbench:window"


def _union(intervals):
    """Merged [start, end) intervals of a list sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _raw_events(prof) -> list:
    """(start ns, end ns, name, on the device, a user annotation) of each
    event of a finished ``torch.profiler.profile``, read from the
    profiler's own results (no per-event objects are built)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append((e.start_ns(), e.end_ns(), e.name(),
                    e.device_type() == cuda, e.is_user_annotation()))
    return out


def device_profile(prof, top: int = 10) -> dict:
    """busy_s, window_s, and the breakdown of a profile whose window is a
    ``record_function(WINDOW_LABEL)``: ``device_ops`` [[name, seconds]] by
    total time and ``idle_gaps`` [[host op at the gap's start, seconds]];
    ``events``, the device operations and host events read. A device event
    counts as an operation unless it is an annotation's range on the
    device timeline (a ``record_function`` range, the program's spans
    among them)."""
    window = None
    ops, cpu = [], []
    for start, end, name, on_device, annotation in _raw_events(prof):
        if on_device:
            if not annotation and name != WINDOW_LABEL:
                ops.append((start, end, name))
        elif name == WINDOW_LABEL:
            if window is None or end - start > window[1] - window[0]:
                window = (start, end)
        else:
            cpu.append((start, end, name))
    events = {"device": len(ops), "host": len(cpu),
              "window": window is not None}
    if window is None:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": [], "events": events}
    w0, w1 = window
    inside = sorted((max(s, w0), min(e, w1)) for s, e, _ in ops
                    if e > w0 and s < w1)
    merged = _union(inside)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(int)
    for s, e, name in ops:
        by_name[name] += e - s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i], edges[i + 1] - edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: -g[1])[:top]
    cpu.sort()

    def host_op(t):
        """The innermost host event running at ``t`` (the latest to start),
        after the innermost operator around it where that event is a CUDA
        runtime or driver call."""
        inner = outer = None
        for s, e, name in cpu:
            if s > t:
                break
            if e >= t:
                inner = name
                if not name.startswith("cu"):
                    outer = name
        if inner is None:
            return "host"
        return inner if outer in (None, inner) else f"{outer} > {inner}"
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": [[n[:160], d / 1e9] for n, d in top_ops],
            "idle_gaps": [[host_op(t), d / 1e9] for t, d in gaps],
            "events": events}
