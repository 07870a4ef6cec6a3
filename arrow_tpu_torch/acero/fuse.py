"""Fused plan execution: the counterpart of the JAX package's
``acero/fuse.py``.

The eager driver (``plan.Declaration.to_table``) reads the host between
stages: the compaction decisions, the join's fanout retries, the
aggregate's route probe. The fused driver runs the plan without them and
defers every data-dependent check to a device flag; all of them come back
with the output lengths in ONE host read at the end, and if one fired the
eager driver runs the plan again (a fused run changes nothing it reads, so
the re-run is always safe). Shapes, as the JAX driver's:

  * every source a one-batch device ``table_source`` (``_chain_single``):
    the whole spine as one chain of calls. A filter's, a probe's output is
    sliced to the padded length an earlier run observed there (adaptive
    capacities, ``_PLAN_OBS``; a longer output fires its flag). A join's
    build runs as its own subplan with one host read of its deferred flags
    and its probe route (the bootstrap form), or, once that route is
    learned (``_PLAN_IMPL``), inside the spine, its route checked by
    device flags (the inline form);
  * otherwise (``_execute``): a pure segment, a source morsel through its
    filters, projects and join probes, runs once a morsel; each join's
    build side runs as its own fused subplan, then builds with its learned
    route (flags) or ``_build_recover`` (one host read) as the bootstrap;
    an aggregate folds its state across the morsels and finalizes once,
    an order_by concatenates and sorts once, with a fetch's limit it folds
    a running top-k.

Joins are inner, left outer, left semi or left anti, not distributed and
not spill-budgeted; an aggregate is keyed, not distributed, not
segmented, and consumes on the generic route (the route probe is a host
read); an order_by is not spill-budgeted, and one with a string key reads
its longest key on the host as the eager node does (the JAX driver sorts
by the default prefix, which misorders longer strings). Any other shape
raises ``_Unsupported`` before anything runs, and the eager driver takes
the plan.

On the card a pure segment is captured once as a ``torch.cuda.CUDAGraph``
(``cuda_kernels.capture_graph``) and replayed for every further morsel of
the same column shapes: the morsel is copied into the graph's inputs, the
graph replays, its outputs are copied out. The first morsel runs as plain
calls (it loads the kernels), and so does a morsel whose shapes would
replay a graph only once (a tail batch). What is captured is decided from
the plan's shape before the capture (``_capturable``: at least one filter,
project or probe, fixed-width columns, packed probes, the expressions'
functions); a capture that fails raises. On the CPU the same segment runs
as plain calls.

The learned state lives in the process. ``ARROW_TPU_PLAN_CACHE`` names a
file that keeps it across processes (unset or empty: none; the JAX package
keeps a store at the repo root by default), repaired from the JAX
package's store (ROADMAP C2): a learned route whose check fired is
removed, so the next run bootstraps again; the file is written to a
temporary file of its own and renamed; keys that hold an object's identity
are neither saved nor loaded; the store is saved on every exit path.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from ..compute.expressions import Expression
from ..compute.scalar import Scalar
from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch, Table, empty_batch
from ..core.interop import pad_capacity
from ..core.schema import Field, Schema
from ..ops.concat import concat_batches
from ..ops.selection import take_batch
from . import nodes as N
from .spill import spill_budget_bytes

__all__ = ["try_fused_to_table", "plan_sig", "STATS", "reset_stats"]

# runs, fallbacks, host reads, graphs captured and replayed, learned routes
# removed: what a caller reads to see the driver's work
STATS = {"fused": 0, "fallbacks": 0, "unsupported": 0, "host_reads": 0,
         "graphs": 0, "replays": 0, "unlearned": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


class _Unsupported(Exception):
    pass


class _FallBack(Exception):
    """A deferred check fired inside a join's build subtree: its output is
    truncated, so the eager driver runs the plan."""


def _read(vals) -> list:
    """ONE host read of ``vals`` (ints or 0-d tensors), counted (none when
    every value is an int)."""
    if any(isinstance(v, torch.Tensor) for v in vals):
        STATS["host_reads"] += 1
    return N.host_ints(vals)


def _flag(x):
    """A check's outcome as a 0-d int32 device flag, or an int."""
    if isinstance(x, torch.Tensor):
        return x.reshape(()).to(torch.int32)
    return int(bool(x))


# ---- signatures -----------------------------------------------------------------

def plan_sig(x) -> object:
    """Hashable structural signature of a node's configuration
    (expressions, options, schemas). Data (tensors, arrays, batches,
    tables) and objects without structure stand by identity: a miss,
    never a wrong hit (JAX ``acero/nodes.py`` ``plan_sig``)."""
    if x is None or isinstance(x, (str, int, float, bool, bytes)):
        return x
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(plan_sig(v) for v in x)
    if isinstance(x, dict):
        return ("map",) + tuple(
            (k, plan_sig(v)) for k, v in sorted(x.items(),
                                                key=lambda kv: str(kv[0])))
    if isinstance(x, Expression):
        return ("expr", x.kind, plan_sig(x.value), x.name, x.function,
                plan_sig(x.args), plan_sig(x.options))
    if isinstance(x, (dt.DataType, Schema, Field)):
        return x
    if isinstance(x, (Array, Batch, Table, torch.Tensor)):
        return ("data", id(x))
    if isinstance(x, np.generic):
        return ("np", x.item())
    if isinstance(x, (datetime.date, datetime.datetime, datetime.timedelta)):
        return ("dt", str(x))
    if isinstance(x, Scalar):
        return ("scalar", x.type, x.is_valid, plan_sig(x.value))
    if hasattr(x, "__dict__"):
        return (type(x).__module__, type(x).__qualname__,
                plan_sig(vars(x)))
    if hasattr(type(x), "__slots__"):
        return (type(x).__module__, type(x).__qualname__,
                plan_sig({s: getattr(x, s, None)
                          for s in type(x).__slots__}))
    try:
        hash(x)
        return x
    except TypeError:
        return ("id", id(x))


def _stage_sig(node) -> tuple:
    """A filter's or project's signature (a project's output names in it:
    two plans that differ only in aliases must not share observations)."""
    if isinstance(node, N.FilterNode):
        return ("filter", plan_sig(node.options.filter_expression))
    return ("project", plan_sig(node.exprs), tuple(node.names))


def _tree_sig(node) -> tuple:
    """Structural signature of a subtree: sources by schema and batch
    capacities, other nodes by their factory and options."""
    if isinstance(node, N.TableSourceNode):
        return ("src", node.table.schema,
                tuple(b.capacity for b in node.table.batches))
    return (node.factory_name, plan_sig(vars(node.options))
            if node.options is not None else None) + \
        tuple(_tree_sig(i) for i in node.inputs)


def _strip_slices(sig) -> tuple:
    """``sig`` without its ("slice", ...) entries at every depth: the
    observation keys must not move when a stage gains a slice."""
    if isinstance(sig, (list, tuple)):
        return tuple(
            _strip_slices(e) for e in sig
            if not (isinstance(e, tuple) and e and e[0] == "slice"))
    return sig


# ---- learned state and its store ---------------------------------------------

# the observed live length of each shrinking stage (filter, join output),
# keyed by its slice-free signature: later runs slice there
_PLAN_OBS: dict = {}
# the probe route each join's build took, keyed by the join's options and
# its build subtree: later runs build inline and check it by flags
_PLAN_IMPL: dict = {}
_PLAN_LOADED = False
_PLAN_DIRTY = False


def _store_path() -> str:
    """``ARROW_TPU_PLAN_CACHE``, read at each call (empty: no store)."""
    return os.environ.get("ARROW_TPU_PLAN_CACHE", "")


def _persistable(key: str) -> bool:
    """A key that names no object by identity (its signature holds no
    ('id', ...) or ('data', ...) leaf): it means the same in another
    process."""
    return "('id', " not in key and "('data', " not in key


def _load_plan_store() -> None:
    global _PLAN_LOADED
    if _PLAN_LOADED:
        return
    _PLAN_LOADED = True
    path = _store_path()
    if not path or not os.path.isfile(path):
        return
    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return          # a damaged store is relearned, not trusted
    for k, v in d.get("obs", {}).items():
        if _persistable(k):
            _PLAN_OBS.setdefault(k, int(v))
    for k, v in d.get("impl", {}).items():
        if _persistable(k):
            _PLAN_IMPL.setdefault(k, str(v))


def _save_plan_store() -> None:
    """Write the persistable entries to a temporary file of this process
    in the store's directory, then rename it over the store."""
    global _PLAN_DIRTY
    path = _store_path()
    if not _PLAN_DIRTY or not path:
        return
    _PLAN_DIRTY = False
    d = {"obs": {k: v for k, v in _PLAN_OBS.items() if _persistable(k)},
         "impl": {k: v for k, v in _PLAN_IMPL.items() if _persistable(k)}}
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".plan_cache.", suffix=".tmp",
                               dir=folder)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(d, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _learn(table: dict, key, value) -> None:
    global _PLAN_DIRTY
    if table.get(key) != value:
        table[key] = value
        _PLAN_DIRTY = True


def _unlearn(keys) -> None:
    """Remove learned routes whose in-run check fired: the next run
    bootstraps again."""
    global _PLAN_DIRTY
    for k in keys:
        if _PLAN_IMPL.pop(k, None) is not None:
            STATS["unlearned"] += 1
            _PLAN_DIRTY = True


# ---- the shape check ----------------------------------------------------------

_JOIN_TYPES = ("inner", "left outer", "left semi", "left anti")


def _check_shape(node) -> None:
    """Raise ``_Unsupported`` for any node the fused driver does not run,
    before anything runs."""
    if isinstance(node, N.TableSourceNode):
        if not node.table.batches:
            raise _Unsupported("empty source")
        return
    if isinstance(node, (N.FilterNode, N.ProjectNode, N.FetchNode)):
        pass
    elif isinstance(node, N.HashJoinNode):
        if node._dist is not None:
            raise _Unsupported("dist join")
        if node.join.join_type not in _JOIN_TYPES:
            raise _Unsupported(f"join type {node.join.join_type}")
        if spill_budget_bytes(node.join.options) is not None:
            raise _Unsupported("spill-budgeted join")
    elif isinstance(node, N.AggregateNode):
        if node.ha is None or node._dist is not None:
            raise _Unsupported("scalar / dist aggregate")
        if getattr(node.options, "segment_keys", ()):
            raise _Unsupported("segmented aggregate")
    elif isinstance(node, N.OrderByNode):
        if spill_budget_bytes(node.options) is not None:
            raise _Unsupported("spill-budgeted order_by")
    else:
        raise _Unsupported(type(node).__name__)
    for i in node.inputs:
        _check_shape(i)


def _all_single(node) -> bool:
    if isinstance(node, N.TableSourceNode):
        return len(node.table.batches) == 1
    return all(_all_single(i) for i in node.inputs)


# ---- stage pieces -----------------------------------------------------------------

def prefix_slice(b: Batch, C: int):
    """``b`` with its leading capacity sliced to C (its live rows are a
    prefix: filter and join outputs), and the flag of a length past C.
    Nested, run-end encoded and child-carrying columns do not slice: the
    batch comes back whole (flag 0)."""
    for a in b.arrays:
        if a.type.is_nested or a.children is not None:
            return b, 0
    n = b.length
    err = _flag(n > C)
    nc = min(n, C) if b.has_static_length else torch.clamp(n, max=C)
    arrays = []
    for a in b.arrays:
        validity = None if a.validity is None else a.validity[:C]
        if a.offsets is not None:
            arrays.append(Array(a.type, a.values, validity, length=nc,
                                offsets=a.offsets[:C + 1]))
        else:
            arrays.append(Array(a.type, a.values[:C], validity, length=nc,
                                dictionary=a.dictionary))
    return Batch(b.schema, arrays, nc, b.index), err


def _tight_capacity(key) -> Optional[int]:
    obs = _PLAN_OBS.get(key)
    return None if obs is None else pad_capacity(int(obs * 1.3) + 16)


def _fetch_slice(x: Batch, offset: int, count: int) -> Batch:
    """Rows [offset, offset + count) of ``x`` with no host read."""
    idx = torch.clamp(torch.arange(x.capacity, dtype=torch.int32,
                                   device=x.device) + offset,
                      max=x.capacity - 1)
    n = x.length - offset
    n = max(min(n, count), 0) if isinstance(n, int) else \
        torch.clamp(n, 0, count)
    return take_batch(x, Array(dt.int32, idx, None, length=n))


def _build_flags(join, bs, impl: str):
    """The flag that checks a learned probe route on this build: its
    capacity, the packed keys' width, the keys' uniqueness."""
    err = _flag(bs.error)
    if impl.startswith("packed"):
        err = err | _flag(bs.pack_bits > 30)
    if impl == "packed_u":
        err = err | _flag(bs.num_groups != bs.num_active)
    return err


def _aggregate_flags(ha, state) -> list:
    """The aggregate's deferred errors: the group table's, each
    aggregator's, each string key's slot overflow."""
    return [(state[0].error, None)] + [(f, None)
                                       for _, f in ha.error_flags(state)]


# ---- one-batch plans: the spine ----------------------------------------------

def _obs_tap(sig: list, obs_keys: list, fn):
    """Wrap a shrinking stage: observe its live length (read with the end
    of the run) and, when an earlier run observed one, slice there behind
    a flag. The key leaves earlier slices out, so one run's observations
    all apply to the next."""
    key = repr(("obs", _strip_slices(sig)))
    C = _tight_capacity(key)
    sig.append(("slice", C))
    obs_keys.append(key)

    def f(*a, _fn=fn, _C=C):
        x, errs, obs = _fn(*a)
        n = x.length                # before the slice: growth is observed
        if _C is not None and _C < x.capacity and x.capacity >= (1 << 16):
            x, e = prefix_slice(x, _C)
            errs = errs + ((e, None),)
        return x, errs, obs + (n,)
    return f


def _chain_single(node, sig: list, obs_keys: list):
    """(args, fn(*args) -> (Batch, errs, observations)): the plan over
    one-batch sources as one chain. ``errs`` are (flag, learned-route key
    or None) pairs; ``sig`` collects the stages' signatures, ``obs_keys``
    the keys of the observations in their order."""
    if isinstance(node, N.TableSourceNode):
        b = node.table.batches[0]
        sig.append(("src", b.schema, b.capacity))
        return [b], lambda b_: (b_, (), ())

    if isinstance(node, (N.FilterNode, N.ProjectNode)):
        args, fn = _chain_single(node.inputs[0], sig, obs_keys)
        sig.append(_stage_sig(node))

        def f(*a, _fn=fn, _run=node._run):
            x, errs, obs = _fn(*a)
            return _run(x), errs, obs
        if isinstance(node, N.FilterNode):
            f = _obs_tap(sig, obs_keys, f)
        return args, f

    if isinstance(node, N.HashJoinNode):
        bsig: list = []
        bobs_keys: list = []
        bargs, bfn = _chain_single(node.inputs[1], bsig, bobs_keys)
        ikey = repr(("impl", plan_sig(vars(node.join.options)),
                     _strip_slices(bsig)))
        impl = _PLAN_IMPL.get(ikey)
        join = node.join
        fanout = join.options.fanout_capacity
        if impl is not None:
            # the inline form: the build runs in the spine, its learned
            # route checked by flags
            sig.append(("hashjoin", plan_sig(vars(join.options)), impl,
                        tuple(bsig)))
            sig.append(("slice", "form", "inline"))
            obs_keys.extend(bobs_keys)      # the build's observations first
            pargs, pfn = _chain_single(node.inputs[0], sig, obs_keys)
            kb = len(bargs)

            def f(*a, _fn=pfn, _bfn=bfn):
                xb, berrs, bobs = _bfn(*a[:kb])
                bs = join.build(xb)
                x, errs, obs = _fn(*a[kb:])
                out, bs2 = join.probe(bs, x, fanout, impl)
                return out, berrs + errs + (
                    (_build_flags(join, bs, impl), ikey),
                    (_flag(bs2.error), None)), bobs + obs
            sig.append(("joinout",))
            return bargs + pargs, _obs_tap(sig, obs_keys, f)
        # the bootstrap form: the build subplan runs now; one host read of
        # its flags and observations, one of its route
        build_in, berrs, bobs = bfn(*bargs)
        vals = _read([e for e, _ in berrs] + list(bobs))
        for k, v in zip(bobs_keys, vals[len(berrs):]):
            _learn(_PLAN_OBS, k, v)
        if any(vals[:len(berrs)]):
            _unlearn([k for (_, k), v in zip(berrs, vals) if v and k])
            raise _FallBack("a check in the build subtree fired")
        jb = node.join
        bs, impl = node._build_recover(build_in)
        STATS["host_reads"] += 1
        if node.join is jb and build_in.capacity < (1 << 26):
            _learn(_PLAN_IMPL, ikey, impl)
        join = node.join
        fanout = join.options.fanout_capacity
        sig.append(("hashjoin", plan_sig(vars(join.options)), impl,
                    tuple(bsig)))
        sig.append(("slice", "form", "boot", build_in.capacity))
        pargs, pfn = _chain_single(node.inputs[0], sig, obs_keys)
        k = len(pargs)

        def f(*a, _fn=pfn):
            x, errs, obs = _fn(*a[:k])
            out, bs2 = join.probe(a[k], x, fanout, impl)
            return out, errs + ((_flag(bs2.error), None),), obs
        sig.append(("joinout",))   # the join's output, not its probe side
        return pargs + [bs], _obs_tap(sig, obs_keys, f)

    if isinstance(node, N.AggregateNode):
        args, fn = _chain_single(node.inputs[0], sig, obs_keys)
        ha = node.ha
        sig.append(("aggregate", plan_sig(node.options.aggregates),
                    tuple(node.options.keys), node._max_groups))

        def f(*a, _fn=fn):
            x, errs, obs = _fn(*a)
            st = ha.consume(ha.init_state(x.device), x, None, None, True)
            return ha.finalize(st), errs + tuple(_aggregate_flags(ha, st)), \
                obs
        return args, f

    if isinstance(node, N.OrderByNode):
        args, fn = _chain_single(node.inputs[0], sig, obs_keys)
        limit = node._limit
        sig.append(("order_by", plan_sig(node.options.sort_keys),
                    node.options.null_placement, limit))

        def f(*a, _fn=fn):
            x, errs, obs = _fn(*a)
            return _sorted(node, x, limit), errs, obs
        return args, f

    if isinstance(node, N.FetchNode):
        args, fn = _chain_single(node.inputs[0], sig, obs_keys)
        off, cnt = int(node.options.offset), int(node.options.count)
        sig.append(("fetch", off, cnt))

        def f(*a, _fn=fn):
            x, errs, obs = _fn(*a)
            return _fetch_slice(x, off, cnt), errs, obs
        return args, f

    raise _Unsupported(type(node).__name__)


def _sorted(node, x: Batch, limit) -> Batch:
    """An order_by's output: its top ``limit`` rows, or all of them (a
    string key's width probe is one host read)."""
    if N._varlen_key_cols(x.schema, node._sort.sort_keys):
        STATS["host_reads"] += 1
    if limit:
        return node._topk(x, limit)
    return take_batch(x, node._sort_indices(x))


# ---- multi-morsel plans: segments and folds -------------------------------------

class _Ctx:
    def __init__(self):
        self.errors: list = []      # (flag, learned-route key or None)


# functions whose torch forms read nothing on the host and copy nothing
# from it: the expressions a captured segment may hold
_CAPTURE_FUNCTIONS = {
    "equal", "not_equal", "less", "less_equal", "greater", "greater_equal",
    "and", "and_kleene", "or", "or_kleene", "invert", "xor", "and_not",
    "and_not_kleene", "add", "subtract", "multiply", "divide", "negate",
    "abs", "is_null", "is_valid"}


def _fixed_width(schema: Schema) -> bool:
    return all(not (f.type.is_varlen or f.type.is_nested or
                    isinstance(f.type, dt.DictionaryType))
               for f in schema.fields)


def _capture_expr(e: Expression, top: bool) -> bool:
    """An expression a capture may hold: fields, literals under a call, and
    calls of ``_CAPTURE_FUNCTIONS`` (a bare literal becomes a column
    copied from the host)."""
    if e.kind == Expression.KIND_FIELD:
        return True
    if e.kind == Expression.KIND_LITERAL:
        return not top
    return e.function in _CAPTURE_FUNCTIONS and \
        all(_capture_expr(a, False) for a in e.args)


def _capturable(node, impls: dict) -> bool:
    """Whether the pure segment rooted at ``node`` is captured on the card:
    it holds at least one filter, project or probe (a bare source has no
    work to capture), every batch in it is of fixed-width columns, every
    filter's and project's expression capturable, every join probed on a
    packed route with no residual filter. ``impls``: each join node's
    route."""
    return not isinstance(node, N.TableSourceNode) and \
        _capture_ok(node, impls)


def _capture_ok(node, impls: dict) -> bool:
    if not _fixed_width(node.output_schema()):
        return False
    if isinstance(node, N.TableSourceNode):
        return True
    if isinstance(node, N.FilterNode):
        ok = _capture_expr(node.options.filter_expression, True)
    elif isinstance(node, N.ProjectNode):
        ok = all(_capture_expr(e, True) for e in node.exprs)
    elif isinstance(node, N.HashJoinNode):
        ok = impls[id(node)].startswith("packed") and \
            node.join.residual is None and \
            _fixed_width(node.inputs[1].output_schema())
    else:
        return False
    return ok and _capture_ok(node.inputs[0], impls)


def _static_like(b: Batch) -> Batch:
    """Fresh tensors of ``b``'s column shapes, its length a 0-d int32:
    a captured segment's inputs."""
    n = torch.zeros((), dtype=torch.int32, device=b.device)
    return Batch(b.schema, [
        Array(a.type, torch.empty_like(a.values),
              None if a.validity is None else torch.empty_like(a.validity),
              length=n) for a in b.arrays], n, b.index)


def _leaf_key(b: Batch) -> tuple:
    return tuple((tuple(a.values.shape), a.values.dtype,
                  a.validity is not None) for a in b.arrays)


def _copy_into(static: Batch, b: Batch) -> None:
    for s, a in zip(static.arrays, b.arrays):
        s.values.copy_(a.values)
        if s.validity is not None:
            s.validity.copy_(a.validity)
    if b.has_static_length:
        static.length.fill_(int(b.length))
    else:
        static.length.copy_(b.length)


def _own(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _owned_batch(b: Batch) -> Batch:
    """``b`` with its tensors copied out of a graph's outputs."""
    return Batch(b.schema, [
        Array(a.type, a.values.clone(), _own(a.validity),
              length=_own(a.length), offsets=_own(a.offsets),
              dictionary=a.dictionary) for a in b.arrays],
        _own(b.length), b.index)


# the replays a graph must have ahead of it to be captured: a capture
# costs more than the plain calls of one morsel
MIN_REPLAYS = 2


class _Segment:
    """A pure segment run over the morsels ``srcs``: the first as plain
    calls; each further one, if ``capture`` and its column shapes recur in
    at least ``MIN_REPLAYS`` further morsels, by replaying the graph
    captured for those shapes; the others as plain calls."""

    def __init__(self, fn, extra, capture: bool, srcs):
        self.fn = fn
        self.extra = extra
        self.ahead = collections.Counter(
            _leaf_key(b) for b in srcs[1:]) if capture else {}
        self.graphs = {}        # column shapes -> (inputs, CapturedGraph)
        self.morsels = 0

    def __call__(self, b: Batch):
        first = self.morsels == 0
        self.morsels += 1
        key = None if first else _leaf_key(b)
        if key is None or self.ahead.get(key, 0) < MIN_REPLAYS:
            return self.fn(b, *self.extra)
        from ..ops.cuda_kernels import capture_graph
        entry = self.graphs.get(key)
        if entry is None:
            static = _static_like(b)
            entry = self.graphs[key] = (static, capture_graph(
                lambda: self.fn(static, *self.extra)))
            STATS["graphs"] += 1
        static, graph = entry
        _copy_into(static, b)
        x, errs = graph.replay()
        STATS["replays"] += 1
        return _owned_batch(x), tuple((_own(e), k) for e, k in errs)


def _prefix(node, ctx: _Ctx, impls: dict):
    """A pure segment: (source batches, extra args, fn(batch, *extra) ->
    (Batch, errs)). Each join's build side runs here, as its own fused
    subplan."""
    if isinstance(node, N.TableSourceNode):
        return list(node.table.batches), [], lambda b: (b, ())

    if isinstance(node, (N.FilterNode, N.ProjectNode)):
        srcs, extra, fn = _prefix(node.inputs[0], ctx, impls)

        def f(b, *ex, _fn=fn, _run=node._run):
            x, errs = _fn(b, *ex)
            return _run(x), errs
        return srcs, extra, f

    if isinstance(node, N.HashJoinNode):
        build_batches = _execute(node.inputs[1], ctx)
        if not build_batches:
            build_in = empty_batch(node.inputs[1].output_schema(),
                                   device=node.device())
        else:
            build_in = concat_batches(build_batches)
        ikey = repr(("impl", plan_sig(vars(node.join.options)),
                     _tree_sig(node.inputs[1])))
        impl = _PLAN_IMPL.get(ikey)
        if impl is not None:
            bs = node.join.build(build_in)
            ctx.errors.append((_build_flags(node.join, bs, impl), ikey))
        else:
            jb = node.join
            bs, impl = node._build_recover(build_in)
            STATS["host_reads"] += 1
            if node.join is jb and build_in.capacity < (1 << 26):
                _learn(_PLAN_IMPL, ikey, impl)
        impls[id(node)] = impl
        srcs, extra, fn = _prefix(node.inputs[0], ctx, impls)
        join = node.join
        fanout = join.options.fanout_capacity
        k = len(extra)

        def f(b, *ex, _fn=fn):
            x, errs = _fn(b, *ex[:k])
            out, bs2 = join.probe(ex[k], x, fanout, impl)
            return out, errs + ((_flag(bs2.error), None),)
        return srcs, extra + [bs], f

    raise _Unsupported(type(node).__name__)


def _segment(node, ctx: _Ctx):
    """(source batches, the segment's runner) of the pure chain at
    ``node``."""
    impls: dict = {}
    srcs, extra, fn = _prefix(node, ctx, impls)
    capture = bool(srcs) and bool(srcs[0].arrays) and \
        srcs[0].device.type == "cuda" and _capturable(node, impls)
    return srcs, _Segment(fn, extra, capture, srcs)


def _execute(node, ctx: _Ctx) -> List[Batch]:
    """A (sub)plan over morsels: its output batches, every check deferred
    into ``ctx.errors``."""
    if isinstance(node, N.AggregateNode):
        srcs, seg = _segment(node.inputs[0], ctx)
        ha = node.ha
        st = ha.init_state(node.device())
        for i, b in enumerate(srcs):
            x, errs = seg(b)
            ctx.errors.extend(errs)
            st = ha.consume(st, x, None, None, i == 0)
        ctx.errors.extend(_aggregate_flags(ha, st))
        return [ha.finalize(st).with_index(0)]

    if isinstance(node, N.OrderByNode):
        inner = _execute(node.inputs[0], ctx)
        if not inner:
            return []
        limit = node._limit
        if not limit:
            return [_sorted(node, concat_batches(inner), None).with_index(0)]
        best = _sorted(node, inner[0], limit)
        for b in inner[1:]:
            best = _sorted(node, concat_batches([best, b]), limit)
        return [best.with_index(0)]

    if isinstance(node, N.FetchNode):
        inner = _execute(node.inputs[0], ctx)
        if len(inner) != 1:
            raise _Unsupported("fetch over several batches")
        return [_fetch_slice(inner[0], int(node.options.offset),
                             int(node.options.count)).with_index(0)]

    srcs, seg = _segment(node, ctx)
    out = []
    for i, b in enumerate(srcs):
        x, errs = seg(b)
        ctx.errors.extend(errs)
        out.append(x.with_index(i))
    return out


# ---- the driver -------------------------------------------------------------------

def _fired(errs, vals) -> bool:
    """Whether a deferred flag fired; the learned routes whose check fired
    are removed."""
    fired = [i for i, v in enumerate(vals) if v]
    if not fired:
        return False
    _unlearn([errs[i][1] for i in fired if errs[i][1]])
    return True


def try_fused_to_table(decl) -> Optional[Table]:
    """The plan's Table through the fused driver, or None when its shape
    is not one the driver takes or a deferred check fired (the caller then
    runs the eager driver). The plan store is saved on every exit."""
    _load_plan_store()
    node = decl._build()
    try:
        _check_shape(node)
        if _all_single(node):
            return _run_single(node)
        return _run_streaming(node)
    except _Unsupported:
        STATS["unsupported"] += 1
        return None
    except _FallBack:
        STATS["fallbacks"] += 1
        return None
    finally:
        _save_plan_store()


def _run_single(node) -> Optional[Table]:
    sig: list = []
    obs_keys: list = []
    args, fn = _chain_single(node, sig, obs_keys)
    out, errs, obs = fn(*args)
    ne = len(errs)
    vals = _read([e for e, _ in errs] + list(obs) + [out.length])
    for k, v in zip(obs_keys, vals[ne:ne + len(obs)]):
        _learn(_PLAN_OBS, k, v)
    if _fired(errs, vals[:ne]):
        STATS["fallbacks"] += 1
        return None
    STATS["fused"] += 1
    n = vals[-1]
    return Table(node.output_schema(), [out.with_length(n)] if n else [])


def _run_streaming(node) -> Optional[Table]:
    ctx = _Ctx()
    batches = _execute(node, ctx)
    ne = len(ctx.errors)
    vals = _read([e for e, _ in ctx.errors] + [b.length for b in batches])
    if _fired(ctx.errors, vals[:ne]):
        STATS["fallbacks"] += 1
        return None
    STATS["fused"] += 1
    return Table(node.output_schema(), [
        b.with_length(n) for b, n in zip(batches, vals[ne:]) if n > 0])
