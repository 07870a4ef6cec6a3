"""Declaration-based plan construction and its drivers.

Reference: ``acero/exec_plan.h:389`` (Declaration), ``exec_plan.cc:647``
(DeclarationToTable), the node factory registry (``exec_plan.h:353``); the
counterpart of the JAX package's ``acero/plan.py``. A Declaration builds
into a tree of nodes (``acero/nodes.py``) whose ``batches()`` the driver
pulls: the host drives a stream of device batches through each node, and
pipeline breakers (aggregate, order_by, join build) hold their state on the
device. Before the build the plan is rewritten: sources keep only the
columns some ancestor reads (``prune_columns``) and a fetch over an
order_by streams top-k (``fuse_topk``).

``to_table`` has three drivers, as the JAX package's: the eager driver,
the default; the fused driver (``acero/fuse.py``, ``fused=True``), tried
first when asked for; the lazy run (``lazy=True``: nodes defer their
checks, ``nodes.LAZY``). A plan whose deferred check fired runs again on
the eager driver. The JAX package picks its drivers by environment
variables and tries the fused one by default; the port takes them as
arguments and runs eager unless asked, because the fused and lazy drivers
lose to it on the card (ROADMAP P13).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Iterator, Optional, Sequence

from ..core.batch import Batch, Table
from . import nodes as _nodes
from .options import (ExecNodeOptions, ProjectNodeOptions,
                      TableSourceNodeOptions)

__all__ = ["Declaration", "ExecNode", "register_node_factory",
           "declaration_to_table", "fuse_topk", "prune_columns"]

register_node_factory = _nodes.register_node_factory
ExecNode = _nodes.ExecNode


class Declaration:
    """An unbuilt node graph (public plan API)."""

    def __init__(self, factory_name: str,
                 options: Optional[ExecNodeOptions] = None,
                 inputs: Sequence["Declaration"] = ()):
        self.factory_name = factory_name
        self.options = options
        self.inputs = list(inputs)

    @staticmethod
    def from_sequence(decls: Sequence["Declaration"]) -> "Declaration":
        """Chain single-input declarations (Declaration::Sequence analog)."""
        out = None
        for d in decls:
            if out is not None:
                d = Declaration(d.factory_name, d.options, [out] + d.inputs)
            out = d
        return out

    def _build(self) -> "_nodes.ExecNode":
        decl = self
        if not os.environ.get("ARROW_TPU_NO_PRUNE"):
            decl = prune_columns(self)
        return fuse_topk(decl)._build_raw()

    def _build_raw(self) -> "_nodes.ExecNode":
        try:
            cls = _nodes.FACTORIES[self.factory_name]
        except KeyError:
            raise KeyError(
                f"no exec node factory named '{self.factory_name}'; "
                f"have {sorted(_nodes.FACTORIES)}") from None
        return cls(self.options, [d._build_raw() for d in self.inputs])

    # ---- materialization ----------------------------------------------------
    def to_batches(self, stop_token=None) -> Iterator[Batch]:
        node = self._build()
        if stop_token is None:
            return node.batches()

        def gen():
            it = node.batches()
            try:
                for b in it:
                    stop_token.raise_if_stopped()
                    yield b
            finally:
                it.close()      # a node's disk state goes with the stop
        return gen()

    def to_table(self, stop_token=None, lazy: bool = False,
                 fused: bool = False) -> Table:
        """Run the plan; its batches of no rows are dropped. A
        ``plan:<factory>`` span covers the run on every driver, and
        ``metrics`` records its rows and wall time.

        ``fused`` tries the fused driver first (not with a ``stop_token``
        or inside a lazy run); a plan it does not take, or whose deferred
        check fired, goes on. ``lazy`` runs the nodes lazily and ends in
        ONE host read of every deferred flag and batch length; a fired
        flag runs the plan again eagerly. The eager run reads its batches'
        lengths in one host read at the end."""
        from ..utils.tracing import metrics, trace_span
        from . import nodes as _n
        name = f"plan:{self.factory_name}"
        t0 = time.perf_counter()
        with trace_span(name):
            t = None
            if fused and not _n.LAZY.active and stop_token is None:
                from .fuse import try_fused_to_table
                t = try_fused_to_table(self)
            if t is None and lazy and not _n.LAZY.active:
                _n.LAZY.active = True
                _n.LAZY.deferred = []
                try:
                    t = self._run_nodes(stop_token, _n.LAZY.deferred)
                finally:
                    _n.LAZY.active = False
                    _n.LAZY.deferred = []
            if t is None:
                t = self._run_nodes(stop_token, [])
        metrics.record(name, t.num_rows, time.perf_counter() - t0)
        return t

    def _run_nodes(self, stop_token, deferred) -> Optional[Table]:
        """Pull the built plan's batches; then ONE host read of the
        ``deferred`` (label, flag) pairs and the batches' lengths. None if
        a flag fired, else the Table of the batches with rows (their
        lengths now host ints)."""
        node = self._build()
        schema = node.output_schema()
        batches = []
        it = node.batches()
        try:
            for b in it:
                if stop_token is not None:
                    stop_token.raise_if_stopped()
                batches.append(b)
        finally:
            it.close()
        vals = _nodes.host_ints([f for _, f in deferred] +
                                [b.length for b in batches])
        if any(vals[:len(deferred)]):
            return None
        return Table(schema, [b.with_length(n) for b, n in
                              zip(batches, vals[len(deferred):]) if n > 0])

    def to_batches_prefetched(self, prefetch: int = 2,
                              stop_token=None) -> Iterator[Batch]:
        """Bounded readahead: a producer thread drives the plan while the
        consumer lags at most ``prefetch`` batches (the pull-engine form
        of Acero's backpressure, ``options.h:369`` BackpressureOptions:
        pause == queue full). The producer's exceptions reach the
        consumer. The plan is built and the producer started at the first
        ``next``; closing the generator (or leaving a ``for`` over it)
        stops the producer at its next put, closes the plan (a node's disk
        state goes) and releases the queued batches.

        On a card the producer runs its work on the consumer's current
        stream at that first ``next``, so a batch the consumer takes has its kernels queued
        before any the consumer queues next: no batch is read on another
        stream than the one that wrote it."""
        import queue as _q
        import threading
        import torch
        q: "_q.Queue" = _q.Queue(maxsize=max(prefetch, 1))
        closed = threading.Event()
        DONE = object()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _q.Full:
                    continue
            return False

        def produce(node, stream):
            ctx = torch.cuda.stream(stream) if stream is not None \
                else contextlib.nullcontext()
            it = node.batches()
            try:
                with ctx:
                    for b in it:
                        if stop_token is not None:
                            stop_token.raise_if_stopped()
                        if not put(b):
                            return
                    put(DONE)
            except BaseException as e:  # the consumer re-raises it
                put(_Failure(e))
            finally:
                it.close()

        def gen():
            # the plan and its producer start at the first next(): a
            # generator closed before it runs never reaches its finally
            node = self._build()
            stream = None
            if torch.cuda.is_available():
                dev = node.device()
                stream = torch.cuda.current_stream(
                    dev if dev.type == "cuda" else None)
            t = threading.Thread(target=produce, args=(node, stream),
                                 daemon=True, name="arrow_tpu_prefetch")
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is DONE:
                        return
                    if isinstance(item, _Failure):
                        raise item.error
                    yield item
            finally:
                closed.set()
                while True:     # release what the producer queued
                    try:
                        q.get_nowait()
                    except _q.Empty:
                        break
                t.join()
        return gen()

    def to_string(self, indent: int = 0) -> str:
        """Plan dump (ExecPlan::ToString analog)."""
        pad = "  " * indent
        opts = type(self.options).__name__ if self.options is not None \
            else ""
        lines = [f"{pad}{self.factory_name}" + (f" [{opts}]" if opts
                                                else "")]
        for i in self.inputs:
            lines.append(i.to_string(indent + 1))
        return "\n".join(lines)

    def to_pyarrow(self):
        return self.to_table().to_pyarrow()

    def to_reader(self):
        return self.to_batches()

    def __repr__(self):
        inner = f"{self.factory_name}"
        if self.inputs:
            inner += "(" + ", ".join(repr(i) for i in self.inputs) + ")"
        return inner


class _Failure:
    """An exception of ``to_batches_prefetched``'s producer, queued for
    the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


def declaration_to_table(decl: Declaration) -> Table:
    return decl.to_table()


def fuse_topk(decl: Declaration) -> Declaration:
    """Rewrite ``fetch(offset, count)`` over ``order_by`` into an order_by
    with an internal row limit (offset + count): the node then streams
    top-k in bounded memory instead of accumulating the whole input
    (acero's SelectK declaration is the same fusion by hand). The fetch
    node stays (it applies the offset)."""
    inputs = [fuse_topk(d) for d in decl.inputs]
    d = decl if all(a is b for a, b in zip(inputs, decl.inputs)) \
        else Declaration(decl.factory_name, decl.options, inputs)
    if (d.factory_name == "fetch" and d.inputs
            and d.inputs[0].factory_name == "order_by"
            and getattr(d.options, "count", -1) >= 0
            and getattr(d.options, "offset", 0) >= 0):
        ob = d.inputs[0]
        o2 = copy.copy(ob.options)
        o2._limit = d.options.offset + d.options.count
        d = Declaration(d.factory_name, d.options,
                        [Declaration("order_by", o2, ob.inputs)]
                        + d.inputs[1:])
    return d


# ---- projection pushdown ------------------------------------------------------
#
# Sources emit only the columns some ancestor reads: every column a plan
# drags along costs a gather in each filter, take and join it passes.
# ``needed=None`` means "everything" (an unknown consumer: the safe default).

def _expr_fields(e) -> set:
    return set(e.field_names()) if e is not None else set()


def prune_columns(decl: Declaration,
                  needed: Optional[frozenset] = None) -> Declaration:
    f = decl.factory_name
    o = decl.options

    def rebuild(options, new_inputs):
        if options is o and all(a is b for a, b in
                                zip(new_inputs, decl.inputs)):
            return decl
        return Declaration(f, options, new_inputs)

    if f == "table_source":
        if needed is None:
            return decl
        table = o.table
        names = [c for c in table.column_names if c in needed]
        if len(names) == len(table.column_names):
            return decl
        return rebuild(TableSourceNodeOptions(
            table.select(names), o.max_batch_rows), [])

    if f == "tpch_gen":
        if needed is None or o.columns is not None:
            return decl
        o2 = copy.copy(o)
        o2.columns = sorted(needed)
        return rebuild(o2, [])

    if f == "filter":
        child_needed = None if needed is None else \
            frozenset(needed | _expr_fields(o.filter_expression))
        return rebuild(o, [prune_columns(decl.inputs[0], child_needed)])

    if f == "project":
        opts2 = o
        if needed is not None:
            names = o.names or [repr(e) for e in o.expressions]
            keep = [i for i, n in enumerate(names) if n in needed]
            if len(keep) < len(names) and keep:
                opts2 = ProjectNodeOptions(
                    [o.expressions[i] for i in keep],
                    [names[i] for i in keep])
        child_needed = frozenset().union(
            *[_expr_fields(e) for e in opts2.expressions]) \
            if opts2.expressions else frozenset()
        return rebuild(opts2,
                       [prune_columns(decl.inputs[0],
                                      frozenset(child_needed))])

    if f == "aggregate":
        child_needed = set(o.keys) | set(getattr(o, "segment_keys", ()))
        for spec in o.aggregates:
            child_needed |= set(spec.targets)
        return rebuild(o, [prune_columns(decl.inputs[0],
                                         frozenset(child_needed))])

    if f == "hashjoin":
        lneed = None if o.left_output is None else \
            frozenset(set(o.left_keys) | set(o.left_output))
        rneed = None if o.right_output is None else \
            frozenset(set(o.right_keys) | set(o.right_output))
        return rebuild(o, [prune_columns(decl.inputs[0], lneed),
                           prune_columns(decl.inputs[1], rneed)])

    if f in ("order_by", "sorted_merge"):
        child_needed = None if needed is None else frozenset(
            needed | {k.name for k in o.sort_keys})
        return rebuild(o, [prune_columns(i, child_needed)
                           for i in decl.inputs])

    if f in ("fetch", "union"):
        return rebuild(o, [prune_columns(i, needed) for i in decl.inputs])

    # other nodes (sources, cross_join): children keep everything
    return rebuild(o, [prune_columns(i, None) for i in decl.inputs])
