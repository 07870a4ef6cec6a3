"""Exec nodes (reference: the node set in ``cpp/src/arrow/acero/`` —
source_node.cc, filter_node.cc, project_node.cc, groupby_aggregate_node.cc,
order_by_node.cc, fetch_node.cc, hash_join_node.cc, union_node.cc); the
eager counterpart of the JAX package's ``acero/nodes.py``.

Each node is a pull-based stage: ``batches()`` yields Batches of tensors
on the plan's device, and the per-batch work runs eagerly as torch ops and
the port's kernels. Pipeline breakers (join build, aggregate, order_by)
read their input through ``materialized_stream``, which shrinks sparse
batches to their capacity bucket after one host read (``maybe_compact``).
Capacity errors (a full group table, a join's build or fanout capacity)
come back in the same host reads as the lengths and recover by doubling,
as in the JAX package.

The lazy mode (``LAZY``, ``Declaration.to_table(lazy=True)``; each thread
has its own): nodes skip the host reads that are heuristics and register
the device flags of their checks with ``LAZY.defer``; the driver reads them
all at the end, with the batch lengths, in ONE host read, and runs the plan
again eagerly if one fired. Node by node, as the JAX package has it:

  * ``maybe_compact`` (and with it ``compact_scalars``' read): skipped;
  * aggregate: the group table's error, each aggregator's flag and each
    string key's slot overflow are deferred instead of read (no replay at
    a doubled ``max_groups``: the eager run does it); the route probe of
    ``consume_routed`` stays (the JAX package keeps its probe read); a
    keyless aggregate keeps its one read;
  * hashjoin: the Bloom pre-filter and its per-batch read are skipped; a
    probe's fanout flag is deferred instead of read (``_probe_retry``);
    the build's one read (``build_and_route``: the route and the build
    capacity's recovery) stays, as the JAX package's ``_build_recover``;
  * fetch's length read, order_by's string-width probe, the ordered
    nodes' reads and the distributed nodes stay as they are.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, resolve_device
from ..core.batch import Batch, Table, empty_batch
from ..core.interop import pad_capacity
from ..core.schema import Field, Schema
from ..compute.expressions import execute_scalar_expression
from ..compute.registry import call_function
from ..compute.scalar import Scalar
from ..ops.aggregates import make_grouped_aggregator
from ..ops.bits import SIGNED_OF, as_signed_bits, unsigned_to_int64, \
    zeros_of
from ..ops.concat import concat_batches
from ..ops.grouper import group_key_lanes
from ..ops.hash_aggregate import HashAggregate, spec_in_type
from ..ops.join import HashJoin
from ..ops.kernel_utils import values_of
from ..ops.selection import filter_batch, take_array, take_batch
from ..ops.sorting import SortOptions, sort_indices_batch
from ..parallel.dist_agg import DistGroupBy
from ..parallel.dist_join import DistHashJoin
from . import options as opts
from .spill import (GracePartitioner, SpillSorter, batch_device_bytes,
                    spill_budget_bytes, spill_supported)

__all__ = ["ExecNode", "FACTORIES", "register_node_factory", "empty_batch",
           "compact_to_bucket", "maybe_compact", "materialized_stream",
           "consume_routed", "build_and_route", "host_ints",
           "batch_device_bytes", "LAZY"]

FACTORIES: Dict[str, type] = {}


def register_node_factory(name: str):
    def deco(cls):
        FACTORIES[name] = cls
        cls.factory_name = name
        return cls
    return deco


# ---- host reads ---------------------------------------------------------------

def host_ints(vals) -> List[int]:
    """Python ints of ``vals`` (ints or 0-d integer tensors), the tensors
    fetched in ONE device-to-host copy: every per-batch decision of the
    engine costs at most one read."""
    dev = [v for v in vals if isinstance(v, torch.Tensor)]
    if not dev:
        return [int(v) for v in vals]
    fetched = iter(torch.stack([v.reshape(()).to(torch.int64)
                                for v in dev]).cpu().tolist())
    return [next(fetched) if isinstance(v, torch.Tensor) else int(v)
            for v in vals]


def _host_probe(vals: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Fetch the aggregate's route probe scalars with ONE device-to-host
    copy."""
    names = list(vals)
    # as int64: a wide unsigned key's range by its value (uint64: its bits,
    # read back as uint64 on the host)
    flat = torch.cat([
        unsigned_to_int64(vals[k].reshape(-1)) if vals[k].dtype in SIGNED_OF
        else vals[k].reshape(-1).to(torch.int64) for k in names])
    host = flat.cpu().numpy()
    out, pos = {}, 0
    for k in names:
        n = vals[k].numel()
        piece = host[pos:pos + n]
        if vals[k].dtype == torch.uint64:
            piece = piece.view(np.uint64)
        out[k] = piece.reshape(vals[k].shape)
        pos += n
    return out


class _LazyPlan(threading.local):
    """The lazy (fully asynchronous) run's context: while ``active``, nodes
    skip their heuristic host reads and ``defer`` the device flags of
    their checks; the driver reads every one at the end (JAX
    ``acero/nodes.py`` ``_LazyPlan``). Each thread has its own: a plan
    pulled by another thread meanwhile (``to_batches_prefetched``'s
    producer) keeps its own checks and retries."""

    def __init__(self):
        self.active = False
        self.deferred: list = []    # (label, 0-d device flag)

    def defer(self, label: str, flag) -> None:
        self.deferred.append((label, flag))


LAZY = _LazyPlan()


# ---- compaction ---------------------------------------------------------------

def compact_scalars(b: Batch) -> list:
    """The device scalars ``maybe_compact`` reads: the length, then the
    used bytes of each varlen column. The hash join fetches them with its
    own scalars in one read. A length past the capacity (a probe whose
    fanout overflowed, which the join retries) reads the last offset."""
    end = min(b.length, b.capacity) if b.has_static_length else \
        torch.clamp(b.length, max=b.capacity)
    return [b.length] + [a.offsets[end] for a in b.arrays
                         if a.type.is_varlen]


def maybe_compact(b: Batch, vals: Optional[list] = None) -> Batch:
    """Shrink a sparsely filled batch to its capacity bucket.

    Pipeline-breaker outputs (join fanout, aggregate finalize) and filtered
    batches keep their input capacity; when the length lands far below it,
    every downstream sort and gather would still pay the full capacity. One
    host read of the length and of each varlen column's used bytes
    (``compact_scalars``; ``vals`` when the caller fetched them with other
    scalars) and prefix slices rebase the batch: its live rows are always a
    prefix, and so are a varlen column's used bytes. Batches up to
    ``ARROW_TPU_COMPACT_MIN`` rows (2^20) and ``ARROW_TPU_COMPACT_MIN_BYTES``
    (16 MB) are left alone (the read costs more than it could save), and so
    is a batch whose buckets are all more than half its capacities; the
    decision is kept on the batch (``_compacted``). Off:
    ``ARROW_TPU_NO_COMPACT=1``, and in a lazy run."""
    if os.environ.get("ARROW_TPU_NO_COMPACT") or LAZY.active:
        return b
    if b.capacity <= int(os.environ.get("ARROW_TPU_COMPACT_MIN",
                                        str(1 << 20))):
        if batch_device_bytes(b) <= int(os.environ.get(
                "ARROW_TPU_COMPACT_MIN_BYTES", str(16 << 20))):
            return b
    if getattr(b, "_compacted", False):
        return b
    if vals is None:
        vals = host_ints(compact_scalars(b))
    return compact_to_bucket(b, vals[0], vals[1:])


def compact_to_bucket(b: Batch, n: int, used_bytes=None) -> Batch:
    """``b`` with its host length ``n``, sliced to the capacity bucket of
    ``n`` (each varlen pool to the bucket of its ``used_bytes``, in column
    order) where a bucket is at most half its capacity; marked
    compacted."""
    target = min(pad_capacity(max(n, 1)), b.capacity)
    used = iter(used_bytes or ())
    # a pool whose used bytes the caller did not read stays whole
    pools = [min(pad_capacity(max(next(used, a.values.shape[0]), 1)),
                 a.values.shape[0])
             if a.type.is_varlen else None for a in b.arrays]
    shrink = target * 2 <= b.capacity or any(
        p is not None and p * 2 <= a.values.shape[0]
        for p, a in zip(pools, b.arrays))
    if not shrink:
        out = b.with_length(n)
    else:
        take = None
        if any(a.type.is_nested for a in b.arrays):
            # nested layouts (lists, structs, unions, run-end encoded) are
            # not rebased by a slice: a take of the first rows
            take = Array(dt.int32, torch.arange(
                target, dtype=torch.int32, device=b.device), length=n)
        out = Batch(b.schema, [
            take_array(a, take) if a.type.is_nested else
            Array(a.type, a.values[:target] if p is None else a.values[:p],
                  None if a.validity is None else a.validity[:target],
                  length=n, dictionary=a.dictionary,
                  offsets=None if p is None else a.offsets[:target + 1])
            for a, p in zip(b.arrays, pools)], n, b.index)
    out._compacted = True   # decision made; spare downstream the read
    return out


def materialized_stream(input_node: "ExecNode") -> Iterator[Batch]:
    """The input's batches, each through ``maybe_compact``: what pipeline
    breakers consume, since their cost scales with input capacity."""
    for b in input_node.batches():
        yield maybe_compact(b)


def _full_column(s: Scalar, capacity: int, length, device) -> Array:
    """A scalar broadcast to a column of ``capacity`` rows."""
    v = values_of(s)        # a wide decimal's: its two limbs
    values = as_signed_bits(v).to(device).expand((capacity,) + v.shape) \
        .clone().view(v.dtype)
    validity = None if s.is_valid else torch.zeros(
        (capacity,), dtype=torch.bool, device=device)
    return Array(s.type, values, validity, length=length)


class ExecNode:
    factory_name = "?"

    def __init__(self, options, inputs: Sequence["ExecNode"]):
        self.options = options
        self.inputs = list(inputs)

    def output_schema(self) -> Schema:
        raise NotImplementedError

    def device(self) -> torch.device:
        """Where the node's batches live: its first input's device (a
        source's own)."""
        if self.inputs:
            return self.inputs[0].device()
        return resolve_device(None)

    def batches(self) -> Iterator[Batch]:
        raise NotImplementedError


# ---- sources ------------------------------------------------------------------

@register_node_factory("table_source")
class TableSourceNode(ExecNode):
    """``source_node.cc:303`` TableSourceNodeOptions: a port Table's
    batches, or a pyarrow Table staged in batches of at most
    ``max_batch_rows`` rows (``SliceAndDeliverMorsel``,
    ``source_node.cc:122``)."""

    def __init__(self, options: opts.TableSourceNodeOptions, inputs):
        super().__init__(options, inputs)
        table = options.table
        if not isinstance(table, Table):        # a pyarrow Table
            table = Table.from_pyarrow(
                table, max_rows_per_batch=options.max_batch_rows)
        self.table = table

    def output_schema(self) -> Schema:
        return self.table.schema

    def device(self) -> torch.device:
        return self.table.device

    def batches(self) -> Iterator[Batch]:
        for i, b in enumerate(self.table.batches):
            yield b.with_index(i)


@register_node_factory("source")
class SourceNode(ExecNode):
    """``source_node.cc:96``: the Batches of a generator."""

    def output_schema(self) -> Schema:
        return self.options.schema

    def batches(self) -> Iterator[Batch]:
        for i, b in enumerate(self.options.generator()):
            yield b.with_index(i)


@register_node_factory("record_batch_source")
@register_node_factory("exec_batch_source")
@register_node_factory("array_vector_source")
class RecordBatchSourceNode(ExecNode):
    """``source_node.cc:303`` RecordBatchSourceNode + the exec-batch /
    array-vector variants (:372, :408): an iterable of batches with a known
    schema; pyarrow batches are staged on the default device as they
    stream."""

    def __init__(self, options: opts.RecordBatchSourceNodeOptions, inputs):
        super().__init__(options, inputs)
        self._schema = options.schema if isinstance(
            options.schema, Schema) else Schema.from_pyarrow(options.schema)

    def output_schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[Batch]:
        for i, rb in enumerate(self.options.batches):
            if not isinstance(rb, Batch):       # a pyarrow RecordBatch
                rb = Batch.from_pyarrow(rb)
            yield rb.with_index(i)


@register_node_factory("record_batch_reader_source")
class RecordBatchReaderSourceNode(ExecNode):
    """``source_node.cc:372`` RecordBatchReaderSourceNode: stream a
    pyarrow.RecordBatchReader through the engine."""

    def __init__(self, options: opts.RecordBatchReaderSourceNodeOptions,
                 inputs):
        super().__init__(options, inputs)
        self._schema = Schema.from_pyarrow(options.reader.schema)

    def output_schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[Batch]:
        for i, rb in enumerate(self.options.reader):
            yield Batch.from_pyarrow(rb).with_index(i)


# ---- per-batch maps -----------------------------------------------------------

@register_node_factory("filter")
class FilterNode(ExecNode):
    """``filter_node.cc:42``: expression -> bool mask -> ``filter_batch``
    (one pass of the stream-compaction kernel on the card)."""

    def output_schema(self) -> Schema:
        return self.inputs[0].output_schema()

    def _run(self, b: Batch) -> Batch:
        mask = execute_scalar_expression(self.options.filter_expression, b)
        return filter_batch(b, mask).with_index(b.index)

    def batches(self) -> Iterator[Batch]:
        for b in self.inputs[0].batches():
            yield self._run(b)


@register_node_factory("project")
class ProjectNode(ExecNode):
    """``project_node.cc:43``: N expressions per batch; a scalar result
    becomes a full column."""

    def __init__(self, options: opts.ProjectNodeOptions, inputs):
        super().__init__(options, inputs)
        self.exprs = options.expressions
        self.names = options.names or [repr(e) for e in self.exprs]
        self._out_schema: Optional[Schema] = None

    def _run(self, b: Batch) -> Batch:
        arrays = []
        for e in self.exprs:
            v = execute_scalar_expression(e, b)
            if isinstance(v, Scalar):
                v = _full_column(v, b.capacity, b.length, b.device)
            arrays.append(v)
        fields = tuple(Field(n, a.type, True)
                       for n, a in zip(self.names, arrays))
        return Batch(Schema(fields), arrays, b.length, b.index)

    def output_schema(self) -> Schema:
        if self._out_schema is None:
            # the types the expressions give, on a 16-row batch of no rows
            probe = empty_batch(self.inputs[0].output_schema(), device="cpu")
            self._out_schema = self._run(probe).schema
        return self._out_schema

    def batches(self) -> Iterator[Batch]:
        for b in self.inputs[0].batches():
            yield self._run(b)


# ---- aggregate ----------------------------------------------------------------

def consume_routed(ha: HashAggregate, state, b: Batch, first: bool = False):
    """One batch through the route the JAX AggregateNode picks
    (``_consume_any``): ONE host read of the key-lane range probe picks the
    dense kernel, the sorted dense reduction past its slot count,
    range-packed sort keys or the generic consume; ``first`` (the state is
    empty) skips the table merge-insert of the two sort routes. Every route
    folds through the same state, so mixed streams are safe."""
    route = ("generic", None)
    lanes = None
    if ha.dense_static_ok() or b.capacity >= (1 << 20):
        # the key lanes serve the probe and the consume (a string key's
        # content lanes are worth building once)
        lanes = group_key_lanes([b.column(k) for k in ha.keys],
                                ha.grouper.key_nullable)
        route = ha.probe_route(b, _host_probe(ha.probe_scalars(b, lanes)))
    kind, params = route
    if kind == "dense":
        del lanes       # the dense routes read the key itself
        return ha.consume_dense(state, b, params["lo"], params["G"],
                                params["impl"])
    if kind == "packed":
        lo, shift, outmap, K, fold = params
        return ha.consume(state, b, (lo, shift, outmap), (K, fold), first,
                          lanes)
    return ha.consume(state, b, None, None, first, lanes)


def _agg_name(spec) -> str:
    return spec.function[5:] if spec.function.startswith("hash_") \
        else spec.function


@register_node_factory("aggregate")
class AggregateNode(ExecNode):
    """``groupby_aggregate_node.cc`` (keyed) / ``scalar_aggregate_node.cc``
    (no keys). Keyed: ``consume_routed`` per batch, then finalize; a full
    group table replays the stream at twice ``max_groups``. Keyed with
    ``dist``: over the context's mesh (``_batches_dist``), where
    ``max_groups`` bounds each shard's groups and nothing replays."""

    def __init__(self, options: opts.AggregateNodeOptions, inputs):
        super().__init__(options, inputs)
        self._dist = getattr(options, "dist", None)
        self._in_schema = self.inputs[0].output_schema()
        self.ha = None
        if options.keys:
            self._make_ha(options.max_groups)

    def _make_ha(self, max_groups: int):
        self.ha = HashAggregate(self._in_schema, self.options.keys,
                                self.options.aggregates,
                                max_groups=max_groups)
        self._max_groups = max_groups

    def output_schema(self) -> Schema:
        if self.ha is not None:
            return self.ha.out_schema
        fields = []
        for spec in self.options.aggregates:
            agg = make_grouped_aggregator(
                spec.function, spec_in_type(self._in_schema, spec), 1,
                spec.options)
            fields.append(Field(spec.out_name, agg.out_type, True))
        return Schema(tuple(fields))

    def batches(self) -> Iterator[Batch]:
        if self.ha is None:
            yield from self._batches_scalar()
            return
        if self._dist is not None:
            yield from self._batches_dist()
            return
        # replay buffer for group-table overflow: batches are kept (refs,
        # no copies) up to a byte budget, so that an overflow re-runs at a
        # doubled group capacity instead of raising
        budget = int(os.environ.get("ARROW_TPU_AGG_REPLAY_BYTES",
                                    str(2 << 30)))
        kept: Optional[list] = []
        kept_bytes = 0
        state = self.ha.init_state(self.device())
        first = True
        for b in materialized_stream(self.inputs[0]):
            state = consume_routed(self.ha, state, b, first)
            first = False
            if kept is not None:
                kept.append(b)
                kept_bytes += batch_device_bytes(b)
                if kept_bytes > budget:
                    kept = None   # too big to replay; raise on overflow
        if LAZY.active:
            LAZY.defer("aggregate group table", state[0].error)
            for agg, flag in self.ha.error_flags(state):
                LAZY.defer(f"aggregate {agg.name}", flag)
            yield self.ha.finalize(state).with_index(0)
            return
        (err,) = host_ints([state[0].error])
        while err and kept is not None and \
                self._max_groups * 2 <= (1 << 26):
            self._make_ha(self._max_groups * 2)
            state = self.ha.init_state(self.device())
            first = True
            for b in kept:
                state = consume_routed(self.ha, state, b, first)
                first = False
            (err,) = host_ints([state[0].error])
        if err:
            raise RuntimeError(
                f"aggregate: group table overflow (error={err}); raise "
                f"AggregateNodeOptions.max_groups (currently "
                f"{self._max_groups})")
        for agg, flag in self.ha.aggregator_errors(state):
            raise RuntimeError(f"aggregate: {agg.error_message(flag)}")
        yield maybe_compact(self.ha.finalize(state).with_index(0))

    def _batches_dist(self) -> Iterator[Batch]:
        """Over the mesh: each input batch is split over the shards and
        pre-aggregated there (``DistGroupBy.consume``), then one state-row
        exchange and merge; aggregators whose state is not one row per
        group concatenate the input and take ``DistContext.group_by``'s
        raw-row shuffle. One batch per shard with groups."""
        o = self.options
        if self.ha.supports_state_exchange:
            dgb = DistGroupBy(self._dist, self._in_schema, o.keys,
                              o.aggregates, max_groups_per_shard=o.max_groups)
            state = dgb.init_state()
            for b in materialized_stream(self.inputs[0]):
                state = dgb.consume(state, b)
            table = dgb.finalize_table(state)
        else:
            accumulated = list(materialized_stream(self.inputs[0])) or \
                [empty_batch(self._in_schema, device=self.device())]
            table = self._dist.group_by(concat_batches(accumulated), o.keys,
                                        o.aggregates,
                                        max_groups_per_shard=o.max_groups)
        for i, b in enumerate(table.batches):
            yield b.with_index(i)

    def _batches_scalar(self) -> Iterator[Batch]:
        """Keyless aggregation. Streaming: every spec with a grouped
        counterpart consumes each batch into a one-group state (the
        Consume / Merge protocol, ``scalar_aggregate_node.cc``), so the
        input never accumulates. Other specs, non-default null options, or
        an input of no rows (whose nulls and zeros are the scalar
        functions') accumulate and reduce once."""
        specs = list(self.options.aggregates)
        aggs = []
        for spec in specs:
            # grouped aggregators skip nulls and give null for no values;
            # other skip_nulls / min_count semantics are the scalar kernels'
            o = spec.options
            default_nulls = o is None or (
                getattr(o, "skip_nulls", True) is True
                and getattr(o, "min_count", 1) == 1)
            if len(spec.targets) > 1 or not default_nulls:
                aggs = None
                break
            in_type = self._in_schema.field(spec.targets[0]).type \
                if spec.targets else None
            try:
                aggs.append(make_grouped_aggregator(_agg_name(spec), in_type,
                                                    1, spec.options))
            except KeyError:
                aggs = None
                break
        if aggs is None:
            yield from self._batches_scalar_accumulate(
                list(self.inputs[0].batches()))
            return
        dev = self.device()
        states = tuple(agg.init(dev) for agg in aggs)
        lengths = []
        for b in materialized_stream(self.inputs[0]):
            gids = torch.where(b.row_mask(), 0, -1).to(torch.int32)
            states = tuple(
                agg.consume(st, b.column(spec.targets[0])
                            if spec.targets else None, gids)
                for agg, spec, st in zip(aggs, specs, states))
            lengths.append(b.length)
        flagged = [(agg, agg.error_flag(st)) for agg, st in zip(aggs, states)
                   if hasattr(agg, "error_flag")]
        counts = host_ints(lengths + [f for _, f in flagged])
        if sum(counts[:len(lengths)]) == 0:
            yield from self._batches_scalar_accumulate([])
            return
        for (agg, _), flag in zip(flagged, counts[len(lengths):]):
            if flag:
                raise RuntimeError(f"aggregate: {agg.error_message(flag)}")
        arrays = [agg.finalize(st, 1) for agg, st in zip(aggs, states)]
        yield Batch(self.output_schema(), arrays, 1, 0)

    def _batches_scalar_accumulate(self, accumulated) -> Iterator[Batch]:
        if not accumulated:
            accumulated = [empty_batch(self._in_schema, device=self.device())]
        big = concat_batches(accumulated)
        arrays = []
        for spec in self.options.aggregates:
            fn = _agg_name(spec)
            if fn == "count_all":
                s = Scalar(len(big), dt.int64)
            else:
                s = call_function(fn, [big.column(t) for t in spec.targets],
                                  options=spec.options)
            arrays.append(_full_column(s, 16, 1, big.device))
        yield Batch(self.output_schema(), arrays, 1, 0)


# ---- order_by, fetch ----------------------------------------------------------

def _varlen_key_cols(schema: Schema, sort_keys) -> List[str]:
    """Sort keys whose order depends on string content: varlen keys and
    dictionary-of-varlen keys."""
    out = []
    for k in sort_keys:
        t = schema.field(k.name).type
        if t.is_varlen or (isinstance(t, dt.DictionaryType)
                           and t.value_type.is_varlen):
            out.append(k.name)
    return out


def probe_varlen_sort_words(b: Batch, sort_keys) -> Optional[int]:
    """u32 prefix words that sort ``b``'s string keys exactly (the longest
    key's bytes / 4, at least the default), from ONE host read of the
    longest row of each; None when no key orders by string content."""
    from ..ops.sorting import _varlen_words_default
    longest = []
    for name in _varlen_key_cols(b.schema, sort_keys):
        c = b.column(name)
        src = c.dictionary if isinstance(c.type, dt.DictionaryType) else c
        if src.offsets.shape[0] > 1:
            longest.append((src.offsets[1:] - src.offsets[:-1]).max())
    if not longest and not _varlen_key_cols(b.schema, sort_keys):
        return None
    maxlen = max(host_ints(longest)) if longest else 0
    return max(_varlen_words_default(), (maxlen + 3) // 4)


@register_node_factory("order_by")
class OrderByNode(ExecNode):
    """``order_by_node.cc:45``: accumulate -> SortIndices -> take.

    With a fused limit (a downstream ``fetch``, ``plan.fuse_topk``) the
    node streams top-k instead: per batch, sort (running best ++ batch) and
    keep the first ``limit`` rows, so memory stays at ``limit + batch``
    rows (the reference's ``select_k_unstable``)."""

    def __init__(self, options: opts.OrderByNodeOptions, inputs):
        super().__init__(options, inputs)
        self._limit = getattr(options, "_limit", None)
        self._sort = SortOptions(options.sort_keys, options.null_placement)

    def output_schema(self) -> Schema:
        return self.inputs[0].output_schema()

    def batches(self) -> Iterator[Batch]:
        if self._limit is not None:
            yield from self._batches_topk(self._limit)
            return
        budget = spill_budget_bytes(self.options)
        can_spill = budget is not None and \
            spill_supported(self.output_schema())
        accumulated: list = []
        acc_bytes = 0
        spill = None
        try:
            for b in materialized_stream(self.inputs[0]):
                if spill is not None:
                    spill.add(b)
                    continue
                accumulated.append(b)
                acc_bytes += batch_device_bytes(b)
                if can_spill and acc_bytes > budget:
                    # the external sort: the accumulated batches go to
                    # sorted runs on disk, and so does the rest
                    spill = SpillSorter(
                        self.output_schema(), self.options.sort_keys,
                        self.options.null_placement, device=b.device)
                    while accumulated:
                        spill.add(accumulated.pop(0))
            if spill is not None:
                for i, b in enumerate(spill.finish()):
                    yield b.with_index(i)
                return
        finally:
            if spill is not None:
                spill.close()
        if not accumulated:
            return
        big = concat_batches(accumulated)
        yield take_batch(big, self._sort_indices(big)).with_index(0)

    def _sort_indices(self, big: Batch) -> Array:
        return sort_indices_batch(
            big, self._sort,
            probe_varlen_sort_words(big, self._sort.sort_keys))

    def _topk(self, big: Batch, limit: int) -> Batch:
        idx = self._sort_indices(big)
        L = min(pad_capacity(limit), big.capacity)
        n = min(big.length, limit) if big.has_static_length \
            else torch.clamp(big.length, max=limit)
        return take_batch(big, Array(idx.type, idx.values[:L], None,
                                     length=n))

    def _batches_topk(self, limit: int) -> Iterator[Batch]:
        best = None
        for b in materialized_stream(self.inputs[0]):
            best = maybe_compact(self._topk(
                b if best is None else concat_batches([best, b]), limit))
        if best is not None:
            yield best.with_index(0)


@register_node_factory("fetch")
class FetchNode(ExecNode):
    """``fetch_node.cc:76``: limit / offset over the (sequenced) stream."""

    def output_schema(self) -> Schema:
        return self.inputs[0].output_schema()

    def batches(self) -> Iterator[Batch]:
        remaining_skip = self.options.offset
        remaining_take = self.options.count
        for b in self.inputs[0].batches():
            if remaining_take <= 0:
                break
            n = len(b)  # a host read: fetch is a stream-control node
            if remaining_skip >= n:
                remaining_skip -= n
                continue
            start = remaining_skip
            take_n = min(n - start, remaining_take)
            remaining_skip = 0
            remaining_take -= take_n
            idx = torch.clamp(torch.arange(b.capacity, dtype=torch.int32,
                                           device=b.device) + start,
                              max=b.capacity - 1)
            yield take_batch(b, Array(dt.int32, idx, None, length=take_n))


# ---- joins --------------------------------------------------------------------

def build_and_route(join: HashJoin, build_in: Batch):
    """(BuildState, error flag, probe impl): build, then ONE host read of
    (error, pack_bits, num_groups, num_active) picks the probe route as the
    JAX package's ``HashJoinNode._build_recover`` does: "packed_u" for
    unique build keys that pack into 30 bits (no pair slots at all),
    "packed" for packable keys with duplicates, else "sort"."""
    bs = join.build(build_in)
    err, bits, ng, na = host_ints(
        [bs.error, bs.pack_bits, bs.num_groups, bs.num_active])
    if bits <= 30 and join.packed_eligible() and \
            build_in.capacity < (1 << 26):
        impl = "packed_u" if (ng == na and join.supports_unique_fast()) \
            else "packed"
    else:
        impl = "sort"
    return bs, err, impl


@register_node_factory("hashjoin")
class HashJoinNode(ExecNode):
    """``hash_join_node.cc:700``: inputs[0] = probe (left), inputs[1] =
    build (right). The build side accumulates and builds once; probe
    batches stream through; right / full outer rows not matched come at the
    end (``finish``). With ``dist``: over the context's mesh
    (``_batches_dist``), without the Bloom pushdown."""

    def __init__(self, options: opts.HashJoinNodeOptions, inputs):
        super().__init__(options, inputs)
        self._dist = getattr(options, "dist", None)
        if self._dist is not None:
            self._dhj = DistHashJoin(
                self._dist, inputs[0].output_schema(),
                inputs[1].output_schema(), options,
                fanout_per_shard=options.fanout_capacity)
            self.join = self._dhj.hj
            return
        # Bloom pushdown (``hash_join_node.cc:499``; options.h:682
        # disable_bloom_filter): probe rows whose keys cannot be in the
        # build side are dropped (or, for left anti, emitted directly)
        # before the probe, and the compaction after it shrinks the probe's
        # capacity. Outer-left joins skip it (negatives would still need
        # null-extended emission).
        jt = options.join_type
        self._bloom_kind = None
        if not getattr(options, "disable_bloom_filter", False):
            if jt in ("inner", "left semi", "right semi", "right anti",
                      "right outer"):
                self._bloom_kind = "drop"
            elif jt == "left anti":
                self._bloom_kind = "split"
        self.join = HashJoin(inputs[0].output_schema(),
                             inputs[1].output_schema(), options)

    def output_schema(self) -> Schema:
        return self.join.out_schema

    def _build_recover(self, build_in: Batch):
        """(BuildState, probe impl): build; more distinct keys than
        ``max_build_rows`` rebuilds at twice the capacity, up to 2^27."""
        bs, err, impl = build_and_route(self.join, build_in)
        while err:
            g = self.join.options.max_build_rows * 2
            if g > (1 << 27):
                raise RuntimeError(
                    "hashjoin build overflow beyond 2^27 distinct keys")
            o2 = copy.copy(self.join.options)
            o2.max_build_rows = g
            self.join = HashJoin(self.join.left_schema,
                                 self.join.right_schema, o2)
            bs, err, impl = build_and_route(self.join, build_in)
        return bs, impl

    def _probe_retry(self, bs, b: Batch, fanout, impl: str):
        """Probe one batch; a fanout overflow retries from the same
        pre-probe state (the probe does not change it in place) at twice
        the fanout, up to 2^27 pair slots. The overflow flag and the
        output's ``compact_scalars`` come back in ONE host read; they ride
        into ``maybe_compact``. Returns (output or None, state, those
        scalars). A lazy run defers the flag instead (no scalars)."""
        out, bs2 = self.join.probe(bs, b, fanout, impl)
        if LAZY.active:
            LAZY.defer("hashjoin fanout", bs2.error)
            return out, bs2, None
        while True:
            vals = host_ints([bs2.error] +
                             (compact_scalars(out) if out is not None
                              else []))
            if not vals[0]:
                return out, bs2, vals[1:]
            fanout = 2 * (fanout or self.join.options.fanout_capacity
                          or b.capacity)
            if fanout > (1 << 27):
                raise RuntimeError(
                    "hashjoin fanout overflow beyond 2^27 pair slots in one "
                    "batch; reduce max_batch_rows upstream")
            out, bs2 = self.join.probe(bs, b, fanout, impl)

    def _bloom_split(self, bits, b: Batch):
        """(rows that may match, rows that cannot as output rows for a
        left anti join, else None)."""
        hit = self.join.bloom_mask(bits, b)
        pos = filter_batch(b, hit)
        if self._bloom_kind != "split":
            return pos, None
        neg = filter_batch(b, Array(dt.bool_, b.row_mask() & ~hit.values,
                                    None, length=b.length))
        return pos, self.join._rename(neg.select(self.join.left_out))

    def batches(self) -> Iterator[Batch]:
        if self._dist is not None:
            yield from self._batches_dist()
            return
        budget = spill_budget_bytes(self.join.options)
        can_grace = budget is not None and \
            spill_supported(self.inputs[0].output_schema()) and \
            spill_supported(self.inputs[1].output_schema())
        build_stream = materialized_stream(self.inputs[1])
        build_batches = []
        build_bytes = 0
        for b in build_stream:
            build_batches.append(b)
            build_bytes += batch_device_bytes(b)
            if can_grace and build_bytes > budget:
                yield from self._batches_grace(build_batches, build_stream)
                return
        if not build_batches:
            build_in = empty_batch(self.inputs[1].output_schema(),
                                   device=self.device())
        else:
            build_in = concat_batches(build_batches)
        del build_batches
        bs, impl = self._build_recover(build_in)
        # the Bloom mask pays only on the generic multi-lane probe: the
        # packed find costs about what the mask does, and the mask adds a
        # host read per probe batch
        bits = self.join.bloom_build(bs) \
            if self._bloom_kind is not None and \
            not impl.startswith("packed") and not LAZY.active else None
        seen = passed = 0
        i = 0
        for b in materialized_stream(self.inputs[0]):
            fanout = None
            if bits is not None:
                pos, neg = self._bloom_split(bits, b)
                if neg is not None:
                    yield maybe_compact(neg.with_index(i))
                    i += 1
                n_in, *pos_vals = host_ints([b.length] + compact_scalars(pos))
                n_pos = pos_vals[0]
                seen += n_in
                passed += n_pos
                if seen >= (1 << 17) and passed * 10 > seen * 9:
                    bits = None   # not selective enough to pay for itself
                if n_pos == 0:
                    continue      # nothing can match; no state to update
                # the default fanout stays sized by the batch before the
                # compaction: shrinking the probe must never shrink the
                # output capacity the plan without the mask would have had
                if self.join.options.fanout_capacity is None:
                    fanout = b.capacity
                b = maybe_compact(pos, vals=pos_vals)
            out, bs, cvals = self._probe_retry(bs, b, fanout, impl)
            if out is not None:
                yield maybe_compact(out.with_index(i), vals=cvals)
                i += 1
        tail = self.join.finish(bs)
        if tail is not None:
            yield tail.with_index(i)

    def _batches_grace(self, initial: list, build_stream
                       ) -> Iterator[Batch]:
        """The Grace hash join: the build side passed the spill budget, so
        BOTH sides hash-partition by join key into K = 16 groups of ATB
        files (``spill.GracePartitioner``: the rows ordered by partition on
        the device by B4 and ``partition_positions``, one host copy a
        column) and the join runs partition by partition. Beside the
        inputs and the output its consumer keeps, the device holds one
        batch's split while partitioning, then a K-th of the build side,
        its join state and one probe morsel: the in-memory join's state
        over the whole build side is what goes (at SF 10, orders joined
        with lineitem: 0.34 GB while partitioning, the output's 3.4 GB
        plus about 0.1 GB while joining, against the in-memory join's
        output plus 2 GB). Equal keys co-partition
        (``HashJoin.partition_ids``), so every
        join type's matched and unmatched semantics hold per partition.
        Each partition builds a join sized to its own rows (never more
        than the options' ``max_build_rows``); its probe and finish size
        their outputs (and string pools) from the partition's batches,
        with the in-memory join's fanout retry. ``initial`` is consumed
        (its batches freed as they are written)."""
        import itertools
        import shutil
        import tempfile
        lschema = self.inputs[0].output_schema()
        rschema = self.inputs[1].output_schema()
        K = 16
        base = tempfile.mkdtemp(prefix="arrow_tpu_grace_")
        try:
            bp = GracePartitioner(rschema, K, "build", base)

            def drain(batches):
                while batches:
                    yield batches.pop(0)
            for b in itertools.chain(drain(initial), build_stream):
                bp.add(b, self.join.partition_ids(b, "build", K))
            pp = GracePartitioner(lschema, K, "probe", base)
            for b in materialized_stream(self.inputs[0]):
                pp.add(b, self.join.partition_ids(b, "probe", K))
            dev = self.device()
            full = self.join.options
            i = 0
            for p in range(K):
                if bp.rows[p] == 0 and pp.rows[p] == 0:
                    continue
                o2 = copy.copy(full)
                o2.max_build_rows = min(full.max_build_rows,
                                        max(bp.rows[p], 16))
                self.join = HashJoin(lschema, rschema, o2)
                runs = list(bp.read_partition(p, device=dev))
                build_in = concat_batches(runs) if runs else \
                    empty_batch(rschema, device=dev)
                del runs
                bs, impl = self._build_recover(build_in)
                del build_in
                for b in pp.read_partition(p, device=dev):
                    out, bs, cvals = self._probe_retry(bs, b, None, impl)
                    if out is not None:
                        yield maybe_compact(out.with_index(i), vals=cvals)
                        i += 1
                tail = self.join.finish(bs)
                del bs
                if tail is not None:
                    yield maybe_compact(tail.with_index(i))
                    i += 1
        finally:
            shutil.rmtree(base, ignore_errors=True)

    def _batches_dist(self) -> Iterator[Batch]:
        """Over the mesh (``parallel/dist_join``): the build batches
        shuffle and accumulate per shard, one build per shard, the probe
        batches stream through the co-partitioning shuffle; each shard's
        output is a batch of its own, sliced to its capacity bucket (its
        length is on the host already), and the tails come last."""
        dhj = self._dhj
        acc = dhj.init_build()
        for b in materialized_stream(self.inputs[1]):
            acc = dhj.consume_build(acc, b)
        ps = dhj.finish_build(acc)
        del acc
        i = 0
        for b in materialized_stream(self.inputs[0]):
            outs, ps = dhj.probe(ps, b)
            for ob in outs:
                yield compact_to_bucket(ob.with_index(i), int(ob.length))
                i += 1
        for ob in dhj.finish(ps):
            yield ob.with_index(i)
            i += 1


@register_node_factory("cross_join")
class CrossJoinNode(ExecNode):
    """Cartesian product (Substrait CrossRel; the reference's Acero has no
    cross node). inputs[0] streams; inputs[1] accumulates. Output pair slot
    j is (left j // nr, right j % nr)."""

    def __init__(self, options, inputs):
        super().__init__(options, inputs)
        lf = list(inputs[0].output_schema().fields)
        rf = list(inputs[1].output_schema().fields)
        dup = {f.name for f in lf} & {f.name for f in rf}
        if dup:
            raise ValueError(f"cross_join duplicate field(s) {sorted(dup)};"
                             " rename before the join")
        self._schema = Schema(tuple(lf + rf))

    def output_schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[Batch]:
        right_batches = list(materialized_stream(self.inputs[1]))
        right = concat_batches(right_batches) if right_batches else \
            empty_batch(self.inputs[1].output_schema(), device=self.device())
        for i, lb in enumerate(materialized_stream(self.inputs[0])):
            T = lb.capacity * right.capacity
            if T > (1 << 26):
                raise ValueError("cross_join pair capacity over 2^26; reduce "
                                 "max_batch_rows upstream")
            dev = lb.device
            nl = torch.as_tensor(lb.length, device=dev)
            nr = torch.as_tensor(right.length, device=dev)
            j = torch.arange(T, dtype=torch.int64, device=dev)
            d = torch.clamp(nr, min=1)
            total = (nl * nr).to(torch.int32)
            li = torch.clamp(j // d, 0, lb.capacity - 1)
            ri = torch.clamp(j % d, 0, max(right.capacity - 1, 0))
            lt = take_batch(lb, Array(dt.int64, li, None, length=total))
            rt = take_batch(right, Array(dt.int64, ri, None, length=total))
            out = Batch(self._schema, list(lt.arrays) + list(rt.arrays),
                        total, i)
            yield maybe_compact(out)


@register_node_factory("union")
class UnionNode(ExecNode):
    """``union_node.cc:50``: concatenation of input streams."""

    def output_schema(self) -> Schema:
        return self.inputs[0].output_schema()

    def batches(self) -> Iterator[Batch]:
        i = 0
        for inp in self.inputs:
            for b in inp.batches():
                yield b.with_index(i)
                i += 1


@register_node_factory("pivot_longer")
class PivotLongerNode(ExecNode):
    """``pivot_longer_node.cc:74``: unpivot by row templates. Each input
    batch is emitted once per template: its feature columns are the
    template's string literals, its measurement columns the input columns
    the template names (null where it names none)."""

    def __init__(self, options: opts.PivotLongerNodeOptions, inputs):
        super().__init__(options, inputs)
        in_schema = inputs[0].output_schema()
        o = options
        # a measurement column's type: that of the first field naming it
        meas_types = []
        for j in range(len(o.measurement_field_names)):
            refs = [t[1][j] for t in o.row_templates if t[1][j] is not None]
            if not refs:
                raise ValueError("measurement column never referenced")
            meas_types.append(in_schema.field(refs[0]).type)
        fields = [Field(n, dt.string, False)
                  for n in o.feature_field_names]
        fields += [Field(n, t, True)
                   for n, t in zip(o.measurement_field_names, meas_types)]
        self._schema = Schema(tuple(fields))
        self._meas_types = meas_types

    def output_schema(self) -> Schema:
        return self._schema

    def _template_batch(self, b: Batch, tmpl) -> Batch:
        feature_values, measurements = tmpl
        cap = b.capacity
        dev = b.device
        arrays = []
        for v in feature_values:
            sb = v.encode()
            off = torch.arange(cap + 1, dtype=torch.int32,
                               device=dev) * len(sb)
            pool = torch.tensor(list(sb), dtype=torch.uint8,
                                device=dev).repeat(cap)
            arrays.append(Array(dt.string, pool, None, length=b.length,
                                offsets=off))
        for j, ref in enumerate(measurements):
            t = self._meas_types[j]
            if ref is None:
                arrays.append(Array(
                    t, zeros_of(t.storage_np, cap, dev),
                    torch.zeros((cap,), dtype=torch.bool, device=dev),
                    length=b.length))
            else:
                arrays.append(b.column(ref))
        return Batch(self._schema, arrays, b.length)

    def batches(self) -> Iterator[Batch]:
        i = 0
        for b in self.inputs[0].batches():
            for tmpl in self.options.row_templates:
                yield self._template_batch(b, tmpl).with_index(i)
                i += 1


# ---- ordered nodes: tpch_gen, sorted_merge, asofjoin -------------------------

@register_node_factory("tpch_gen")
class TpchGenNode(ExecNode):
    """Built-in TPC-H table generator (``tpch_node.cc:3362`` TpchGen):
    generates on the host (``utils/tpch.py``, pyarrow imported there) and
    feeds the plan as a table_source does, in batches of at most
    ``max_batch_rows`` rows on the options' device (the default device
    when it names none). Only the options' ``columns`` are generated when
    they are set (the plan's projection pushdown sets them)."""

    def __init__(self, options: opts.TpchGenNodeOptions, inputs):
        super().__init__(options, inputs)
        from ..utils.tpch import tpch_table
        pa_table = tpch_table(options.table_name,
                              scale_factor=options.scale_factor,
                              seed=options.seed, columns=options.columns)
        self.table = Table.from_pyarrow(
            pa_table, max_rows_per_batch=options.max_batch_rows,
            device=options.device)

    def output_schema(self) -> Schema:
        return self.table.schema

    def device(self) -> torch.device:
        return self.table.device

    def batches(self) -> Iterator[Batch]:
        for i, b in enumerate(self.table.batches):
            yield b.with_index(i)


@register_node_factory("scan")
class ScanNode(ExecNode):
    """``dataset/scan_node.cc:123``: a dataset scan as a plan source.
    Pruning and the residual filter live in ``dataset.Scanner``; this node
    adapts it to the plan's batch protocol. Its schema comes from the
    first selected fragment's metadata (``Fragment.physical_schema``: the
    parquet footer, the IPC schema, the ATB header), the partition columns
    appended."""

    def __init__(self, options: opts.ScanNodeOptions, inputs):
        super().__init__(options, inputs)
        self._scanner = options.dataset.scanner(
            columns=options.columns, filter=options.filter,
            batch_rows=options.batch_rows, device=options.device)
        self._schema = None

    def output_schema(self) -> Schema:
        if self._schema is None:
            sch = self._scanner.dataset_schema()
            if sch is None:
                raise ValueError("scan matched no fragments")
            schema = Schema.from_pyarrow(sch)
            cols = self.options.columns
            self._schema = schema.select(cols) if cols else schema
        return self._schema

    def device(self) -> torch.device:
        return self._scanner.device

    def batches(self) -> Iterator[Batch]:
        for i, b in enumerate(self._scanner.to_batches()):
            yield b.with_index(i)


def _exact_sort(b: Batch, keys, null_placement: str, words=None) -> Batch:
    """``b`` sorted by ``keys`` (varlen keys exact to ``words`` prefix
    words)."""
    from ..ops.sorting import _composite_sort_perm
    perm = _composite_sort_perm([b.column(k.name) for k in keys],
                                [k.order for k in keys], null_placement,
                                b.capacity, b.length, varlen_words=words)
    return take_batch(b, Array(dt.int64, perm, None, length=b.length))


def _carry_like(carry: Batch, like: Batch) -> Batch:
    """The empty carry with ``like``'s dictionaries in its dictionary
    columns, so that the merged rows keep theirs, and a validity only
    where ``like``'s column has one: an all-false validity of the empty
    carry would give every merged column one (a byte a row)."""
    return Batch(carry.schema, [
        Array(a.type, a.values,
              a.validity if like.column(j).validity is not None else None,
              length=a.length, offsets=a.offsets,
              dictionary=like.column(j).dictionary
              if isinstance(a.type, dt.DictionaryType) else a.dictionary,
              children=a.children)
        for j, a in enumerate(carry.arrays)], carry.length)


def _owned(b: Batch) -> Batch:
    """``b`` with every buffer that views a larger storage copied: a
    merge's output outlives its round, and a prefix view of the round's
    sorted batch would hold all of it."""
    def own(t):
        return t if t is None or t.untyped_storage().nbytes() == t.nbytes \
            else t.clone()
    return Batch(b.schema, [
        Array(a.type, own(a.values), own(a.validity), length=a.length,
              offsets=own(a.offsets), dictionary=a.dictionary,
              children=a.children) for a in b.arrays], b.length, b.index)


def streaming_sorted_merge(iters, schema: Schema, sort_keys,
                           null_placement: str,
                           device=None) -> Iterator[Batch]:
    """Bounded-memory k-way merge of internally sorted batch streams (the
    JAX package's ``streaming_sorted_merge``; the algorithm is
    ``SortedMergeNode``'s docstring).

    Rows compare across batches by ``sorting.merge_key_lanes`` (dictionary
    keys by their values' lanes, string keys by prefix words, exact up to
    ``ARROW_TPU_SORT_PREFIX_BYTES``). Each pulled batch costs ONE host read
    (its last row's key lanes and its longest string key); a batch whose
    string keys are longer than the prefix turns the rest of the merge
    into one exact sort with a prefix that covers them, which is safe at
    any round: every row emitted so far precedes every row not yet seen.
    Each round sorts the carry with the pulled batch, emits the prefix at
    or below the bound (the least of the inputs' tail keys), and keeps the
    rest; ONE host read a round fetches both parts' compaction scalars."""
    from ..ops.sorting import (_varlen_words_default, lex_leq,
                               merge_key_lanes)
    keys, npl = sort_keys, null_placement
    vcols = _varlen_key_cols(schema, keys)
    len_budget = 4 * _varlen_words_default()
    its = list(iters)
    k = len(its)
    tails: list = [None] * k
    pending: list = []
    long_strings = False

    def tail_scalars(b: Batch) -> list:
        """The length, the last row's key lanes, the longest string key."""
        last = max(b.length - 1, 0) if b.has_static_length else \
            (b.length - 1).clamp(min=0).long()
        out = [b.length] + [l[last] for l in merge_key_lanes(b, keys, npl)]
        for name in vcols:
            c = b.column(name)
            src = c.dictionary if isinstance(c.type, dt.DictionaryType) \
                else c
            out.append((src.offsets[1:] - src.offsets[:-1]).max())
        return out

    def pull(i: int) -> None:
        nonlocal long_strings
        for b in its[i]:
            t = host_ints(tail_scalars(b))
            if t[0] == 0:
                continue
            t = t[1:]
            nk = len(t) - len(vcols)
            if vcols and max(t[nk:]) > len_budget:
                long_strings = True
            tails[i] = tuple(t[:nk])
            pending.append(b)
            return
        tails[i] = None

    for i in range(k):
        pull(i)
    carry = empty_batch(schema, device=device if device is not None
                        else (pending[0].device if pending else None))
    if pending:
        carry = _carry_like(carry, pending[0])
    out_i = 0
    while not long_strings:
        alive = [i for i in range(k) if tails[i] is not None]
        if not alive:
            break
        bound = min(tails[i] for i in alive)
        working = concat_batches([carry] + pending) if pending else carry
        pending = []
        sb = _exact_sort(working, keys, npl)
        cap = sb.capacity
        live = sb.row_mask()
        n_emit = (lex_leq(merge_key_lanes(sb, keys, npl), bound)
                  & live).sum(dtype=torch.int32)
        iota = torch.arange(cap, dtype=torch.int32, device=sb.device)
        emit = sb.with_length(n_emit)
        rest = take_batch(sb, Array(
            dt.int32, torch.clamp(iota + n_emit, max=cap - 1), None,
            length=sb.length - n_emit))
        e_scal, c_scal = compact_scalars(emit), compact_scalars(rest)
        vals = host_ints(e_scal + c_scal)
        ev, cv = vals[:len(e_scal)], vals[len(e_scal):]
        if ev[0]:
            yield _owned(maybe_compact(emit.with_index(out_i), vals=ev))
            out_i += 1
        carry = maybe_compact(rest, vals=cv)
        pull(min(alive, key=lambda i: tails[i]))
    if long_strings:
        acc = [carry] + pending
        for i in range(k):
            if tails[i] is not None:
                acc.extend(its[i])
        big = concat_batches([b for b in acc if b.capacity])
        yield _exact_sort(big, keys, npl,
                          probe_varlen_sort_words(big, keys)
                          ).with_index(out_i)
        return
    if int(carry.length):
        yield carry.with_index(out_i)


@register_node_factory("sorted_merge")
class SortedMergeNode(ExecNode):
    """``sorted_merge_node.cc:256``: a k-way merge of inputs that are each
    ordered by ``sort_keys``.

    Streaming, as in the JAX package: the reference's heap merge is a loop
    over rows; here each round sorts (carry ++ newly pulled batch) on the
    device and emits the prefix at or below the bound, the least of the
    inputs' tail keys (the last row of each input's latest batch): no
    unseen row can precede it. The rest carries to the next round, so
    memory stays near one batch an input. One input is one sort of its
    batches' concatenation."""

    def __init__(self, options: opts.SortedMergeNodeOptions, inputs):
        super().__init__(options, inputs)

    def output_schema(self) -> Schema:
        return self.inputs[0].output_schema()

    def batches(self) -> Iterator[Batch]:
        keys, npl = self.options.sort_keys, self.options.null_placement
        if len(self.inputs) >= 2:
            yield from streaming_sorted_merge(
                [materialized_stream(inp) for inp in self.inputs],
                self.output_schema(), keys, npl, self.device())
            return
        acc = list(materialized_stream(self.inputs[0]))
        if not acc:
            return
        big = concat_batches(acc) if len(acc) > 1 else acc[0]
        yield _exact_sort(big, keys, npl,
                          probe_varlen_sort_words(big, keys)).with_index(0)


@register_node_factory("asofjoin")
class AsofJoinNode(ExecNode):
    """``asof_join_node.cc``: the ordered temporal join. Each left row
    takes the right payload of the latest right row of its ``by`` key whose
    ``on`` is at or before its own and within the tolerance (tolerance >=
    0: the earliest at or after it), else nulls.

    As in the JAX package: instead of the reference's per-input queues and
    row cursors, the ``by`` keys are grouped by one ``Grouper``, both sides
    sort together by (inactive, group, on, side), right before left at an
    equal ``on`` (so the later right row of a tie wins), and one segmented
    carry of the last right row (``segment.segmented_carry_last``: the
    doubling ``segmented_scan`` of "the right row if any, else the carry",
    in a constant number of passes) gives every left row its candidate. A
    tolerance >= 0 mirrors ``on`` (negates it) into the past case."""

    def __init__(self, options: opts.AsofJoinNodeOptions, inputs):
        super().__init__(options, inputs)
        from ..ops.grouper import Grouper
        lschema = inputs[0].output_schema()
        rschema = inputs[1].output_schema()
        o = options
        self.right_payload = [n for n in rschema.names
                              if n != o.right_on and n not in o.right_by]
        fields = list(lschema.fields)
        for n in self.right_payload:
            f = rschema.field(n)
            fields.append(Field(f.name, f.type, True))
        self._schema = Schema(tuple(fields))
        by_fields = [lschema.field(k) for k in o.left_by]
        self._grouper = Grouper(
            [f.type for f in by_fields],
            [f.nullable or rschema.field(rk).nullable
             for f, rk in zip(by_fields, o.right_by)],
            max_groups=o.max_by_groups)

    def output_schema(self) -> Schema:
        return self._schema

    def _run(self, left: Batch, right: Batch) -> Batch:
        from ..ops.bits import U32, split_u64
        from ..ops.distinct import _lexsort_perm
        from ..ops.segment import _scatter, segmented_carry_last
        o = self.options
        capL, capR = left.capacity, right.capacity
        dev = left.device
        # both sides' by keys grouped by ONE sort (right rows first)
        g = self._grouper
        lanes = torch.cat([
            group_key_lanes([right.column(k) for k in o.right_by],
                            g.key_nullable),
            group_key_lanes([left.column(k) for k in o.left_by],
                            g.key_nullable)])
        _, rep_gids, sg, _ = g.consume_lanes_grouped(
            g.init_state(dev), lanes,
            torch.cat([right.row_mask(), left.row_mask()]), first=True)
        R = rep_gids.shape[0]
        gid = torch.where(sg.codes >= 0, rep_gids[
            sg.codes.clamp(0, max(R - 1, 0)).long()], -1).to(torch.int64)
        gid_l = gid[capR:]
        on_l = left.column(o.left_on).values.to(torch.int64)
        on_r = right.column(o.right_on).values.to(torch.int64)
        if o.tolerance >= 0:        # the future match mirrored to the past
            on_l, on_r = -on_l, -on_r
        on_hi, on_lo = split_u64(torch.cat([on_r, on_l]))
        side = torch.cat([torch.zeros((capR,), dtype=torch.int64,
                                      device=dev),
                          torch.ones((capL,), dtype=torch.int64,
                                     device=dev)])
        inactive = (gid < 0).to(torch.int64)
        order = _lexsort_perm([(inactive, 1), (gid & U32, 32),
                               (on_hi ^ (1 << 31), 32), (on_lo, 32),
                               (side, 1)])
        s_gid = gid[order]
        head = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          s_gid[1:] != s_gid[:-1]])
        # the right row of each sorted position (-1 for a left row)
        s_ridx = torch.where(order < capR, order, -1).to(torch.int32)
        last_right = segmented_carry_last(s_ridx, head)
        # each left row's candidate back at its row (torch's scatter does
        # not drop: right positions go to the dump slot explicitly)
        src = order - capR
        cand = _scatter(capL, -1, torch.where(src >= 0, src, capL),
                        last_right)
        candc = cand.clamp(0, max(capR - 1, 0)).long()
        matched = (cand >= 0) & (gid_l >= 0) & \
            (on_l - on_r[candc] <= abs(o.tolerance)) & left.row_mask()
        idx = Array(dt.int32, candc.to(torch.int32), matched,
                    length=left.length)
        out = list(left.arrays) + [take_array(right.column(n), idx)
                                   for n in self.right_payload]
        return Batch(self._schema, out, left.length)

    def batches(self) -> Iterator[Batch]:
        """Streaming: both inputs are ordered by ``on`` (the reference's
        contract), so the right side keeps only a carry: per left batch
        ONE host read of its last ``on``, right batches pulled (one host
        read each, of its last ``on``) until one passes the batch's reach,
        then the carry shrinks (a filter: one launch of the compaction
        kernel) to the rows a later left row can still match: at or after
        (last left ``on`` - |tolerance|), or after the last left ``on`` for
        a future match."""
        o = self.options
        rschema = self.inputs[1].output_schema()
        tol = o.tolerance

        def last_on(b: Batch, col: str) -> int:
            return int(b.column(col).values[max(int(b.length) - 1, 0)])

        rights = self.inputs[1].batches()
        carry = None
        right_done = False
        right_tail = None
        for i, lb in enumerate(b for b in self.inputs[0].batches()
                               if int(b.length)):
            lmax = last_on(lb, o.left_on)
            reach = lmax + max(tol, 0)
            pulled = []
            while not right_done and (right_tail is None
                                      or right_tail <= reach):
                rb = next(rights, None)
                if rb is None:
                    right_done = True
                    break
                if int(rb.length) == 0:
                    continue
                pulled.append(rb)
                right_tail = last_on(rb, o.right_on)
            if pulled:          # one concat a left batch
                carry = concat_batches(
                    ([carry] if carry is not None else []) + pulled)
            working = carry if carry is not None else \
                empty_batch(rschema, device=lb.device)
            yield maybe_compact(self._run(lb, working).with_index(i))
            if carry is not None:
                th = lmax + tol if tol < 0 else lmax
                on = carry.column(o.right_on).values.to(torch.int64)
                carry = maybe_compact(filter_batch(
                    carry, Array(dt.bool_, on >= th, None,
                                 length=carry.length)))
