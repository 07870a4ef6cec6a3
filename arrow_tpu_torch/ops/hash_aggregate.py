"""Grouped hash aggregation: Grouper + GroupedAggregators glued together.

Reference: ``GroupByNode`` (``acero/groupby_aggregate_node.cc``; Consume
:210, Merge :255, Finalize :300). The counterpart of the JAX package's
``ops/hash_aggregate.py``. One probe of the key range on the host picks
the route (``probe_route``):

  * "dense" when the single integer key spans a small domain:
    ``consume_dense`` reduces every aggregate in one pass of the
    ``dense_group_reduce`` CUDA kernel, which reads the columns as they
    are (its native 64-bit kinds and validity streams), and folds the
    per-slot partials into the state through ``merge_rows``;
  * "packed" / "generic": ``consume`` sort-groups the batch by key (the key
    lanes range-packed into fewer sort keys where the probe allows), runs
    the grouper table over the unique reps and segment-reduces every
    aggregate (``ops/segment``).

Past the kernel's slot count (``DENSE_CAP``) and up to
``SORTED_DENSE_CAP`` slots ``consume_dense`` takes ``sorted_group_reduce``
instead: the same interface, one stable sort by slot.

String keys, plain or dictionary-encoded, take the sort routes on their
content lanes (``ops/grouper``); a varlen key's uniques live in byte slots
(``SlotStrings``) until ``finalize`` makes them a varlen Array, and a key
longer than the slot is reported by ``aggregator_errors``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, nulls, resolve_device, row_mask, \
    value_row_shape
from ..core.batch import Batch
from ..core.schema import Field, Schema
from .aggregates import GroupedAggregator, make_grouped_aggregator
from .bits import SIGNED_OF, float_extreme_key, float_from_extreme_key, \
    from_ordered_signed, lane_windows, ordered_signed, unsigned_to_int64
from .cuda_kernels import _DG_ARITY, _DG_IDENT, DenseKey, dense_group_reduce, \
    dense_key_gid
from .grouper import Grouper, GrouperState, SlotStrings, group_key_lanes
from .segment import extreme_identity, make_segment_context

__all__ = ["AggregateSpec", "HashAggregate", "sorted_group_reduce",
           "spec_in_type"]

_I32MAX = (1 << 31) - 1
# dump slots of ``sorted_group_reduce``'s scatter reductions (a power of two)
_DUMP_SLOTS = 4096


def sorted_group_reduce(gid, inputs, kinds: tuple, G: int, valid=None):
    """Dense-domain grouped reduction for LARGE G: the sorted complement of
    ``cuda_kernels.dense_group_reduce``, with its interface (a gid or a
    ``DenseKey``, a validity stream per kind) for the kinds ``consume_dense``
    passes: "first_row", "count", "sum" / "min" / "max" over float32,
    "sum64" / "min64" / "max64" over int64 and "any8" / "all8" over bool.
    Returns (rows (G,) int32, outs).

    ONE stable sort by slot groups the rows; the slot of an output IS
    ``key - lo``, so there is no group table and no unique-key extraction.
    Per-slot bounds are two G-sized binary searches of the sorted slots.
    Integer sums and counts are cumsum boundary differences (exact), float
    sums one ``torch.segment_reduce`` pass over the runs (each run summed
    from its first row to its last), the first row sits at its run's head
    because the sort is stable, and an extreme is one ``scatter_reduce_``
    of the rows as they lie (it needs no order); the rows it must drop go
    to 4096 dump slots in turn, not to one (on an NVIDIA H100 80GB HBM3,
    700.00 W, the atomics of 50.5M dropped rows on ONE slot made each
    100M-row ``scatter_reduce_`` take 41.5 to 42.0 ms, ``PERF.md`` section
    6). The JAX package scans the
    sorted streams with a doubling scan per extreme and feeds 64-bit
    values as limb and pair streams; the results are the same, a float sum
    in another order."""
    if isinstance(gid, DenseKey):
        gid = dense_key_gid(gid, G)
    n = gid.shape[0]
    dev = gid.device
    valid = (None,) * len(kinds) if valid is None else valid
    slot = torch.where((gid >= 0) & (gid < G), gid, G)     # G: inactive
    sk, perm = torch.sort(slot, stable=True)
    gidx = torch.arange(G, dtype=slot.dtype, device=dev)
    starts = torch.searchsorted(sk, gidx)
    ends = torch.searchsorted(sk, gidx, right=True)
    rows = (ends - starts).to(torch.int32)
    present = rows > 0
    offsets = torch.cat([starts, ends[-1:]])
    slot64 = dump = None

    outs = []
    ij = 0
    for kind, v in zip(kinds, valid):
        x = inputs[ij] if _DG_ARITY[kind][0] else None
        ij += _DG_ARITY[kind][0]
        if kind == "first_row":
            first = perm[starts.clamp(max=max(n - 1, 0))] if n else starts
            outs.append(torch.where(present, first, _I32MAX)
                        .to(torch.int32))
        elif kind in ("count", "sum64"):
            xs = (x if v is None else torch.where(v, x, 0))[perm]
            C = torch.cat([xs.new_zeros((1,)),
                           torch.cumsum(xs, 0, dtype=xs.dtype)])
            outs.append(C[ends] - C[starts])
        elif kind == "sum":
            xs = (x if v is None else torch.where(v, x, 0.0))[perm]
            outs.append(torch.segment_reduce(xs, "sum", offsets=offsets,
                                             unsafe=True))
        elif kind in ("min", "max", "min64", "max64", "any8", "all8"):
            if slot64 is None:
                dump = G + (torch.arange(n, device=dev) & (_DUMP_SLOTS - 1))
                slot64 = torch.where(slot < G, slot, dump)
            at = slot64 if v is None else torch.where(v, slot64, dump)
            is_min = kind in ("min", "min64", "all8")
            if kind in ("any8", "all8"):
                x = (x != 0).to(torch.int32)
            elif kind in ("min", "max"):
                x = float_extreme_key(x, is_min)    # NaN skipped
            buf = torch.full((G + _DUMP_SLOTS,), extreme_identity(
                x.dtype, is_min) if kind in ("min", "max")
                else _DG_IDENT[kind], dtype=x.dtype, device=dev)
            out = buf.scatter_reduce_(0, at, x,
                                      "amin" if is_min else "amax")[:G]
            outs.append(float_from_extreme_key(out, is_min, torch.float32)
                        if kind in ("min", "max") else out)
        else:
            raise NotImplementedError(
                f"sorted_group_reduce kind {kind!r}: the limb and pair "
                "streams of the 32-bit kernel interface have native 64-bit "
                "kinds here")
    return rows, outs


class _SlotOverflow:
    """Error carrier of a varlen key longer than its unique slot (reported
    like an aggregator's error)."""

    def __init__(self, key: str, slot_bytes: int):
        self.name = f"key '{key}'"
        self._slot_bytes = slot_bytes

    def error_message(self, flag: int) -> str:
        return (f"group key string in {self.name} exceeds the "
                f"{self._slot_bytes}-byte unique slot; raise "
                f"varlen_slot_bytes (or dictionary-encode the key)")


@dataclass(frozen=True)
class AggregateSpec:
    """One aggregate: (input column or None for count_all, function,
    options, output field name). Mirrors Arrow's Aggregate struct
    (``compute/api_aggregate.h``)."""
    function: str                  # e.g. "sum" or "hash_sum"
    target: object = None          # input column (str) or None (count_all)
    options: object = None
    name: Optional[str] = None     # output column; default "{target}_{fn}"

    @property
    def targets(self) -> tuple:
        if self.target is None:
            return ()
        if isinstance(self.target, (tuple, list)):
            return tuple(self.target)
        return (self.target,)

    @property
    def out_name(self) -> str:
        if self.name:
            return self.name
        fn = self.function[5:] if self.function.startswith("hash_") \
            else self.function
        ts = self.targets
        return "_".join(ts + (fn,)) if ts else fn


def spec_in_type(schema: Schema, spec: AggregateSpec):
    """The aggregator's input type: its target's type, a tuple of them for
    several targets (``hash_pivot_wider``'s (key, value)), None for
    none."""
    ts = spec.targets
    if len(ts) > 1:
        return tuple(schema.field(t).type for t in ts)
    return schema.field(ts[0]).type if ts else None


def _probe_key_domain(key: Array):
    """(min, max) of the key over active (in-range, non-null) rows; if no
    active rows, min > max."""
    act = key.present_mask()
    v = key.values
    wide_unsigned = v.dtype in SIGNED_OF    # torch has no min / max of them
    if wide_unsigned:
        v = ordered_signed(v)
    info = torch.iinfo(v.dtype)
    lo = torch.where(act, v, info.max).min()
    hi = torch.where(act, v, info.min).max()
    if wide_unsigned:
        lo, hi = from_ordered_signed(torch.stack([lo, hi]), key.values.dtype)
    return lo, hi


class HashAggregate:
    """Static-config grouped aggregation over a stream of batches."""

    # dense-slot caps of the JAX package's routing (DENSE_CAP for the
    # kernel, SORTED_DENSE_CAP for the sorted dense reduction), so that
    # both packages route a batch alike
    DENSE_CAP = 4096
    SORTED_DENSE_CAP = 1 << 20
    _DENSE_FNS = {"count", "count_all", "sum", "mean", "min", "max",
                  "any", "all"}

    def __init__(self, in_schema: Schema, keys: Sequence[str],
                 aggs: Sequence[AggregateSpec], max_groups: int = 1 << 16):
        self.in_schema = in_schema
        self.keys = tuple(keys)
        self.aggs = tuple(aggs)
        self.max_groups = max_groups
        key_fields = [in_schema.field(k) for k in keys]
        self.grouper = Grouper([f.type for f in key_fields],
                               [f.nullable for f in key_fields],
                               max_groups=max_groups)
        self._aggregators = []
        for spec in self.aggs:
            self._aggregators.append(make_grouped_aggregator(
                spec.function, spec_in_type(in_schema, spec), max_groups,
                spec.options))
        # output column order matches pyarrow Table.group_by: keys first
        fields = [Field(k, f.type, True) for k, f in zip(keys, key_fields)]
        self.key_fields = list(fields)
        agg_fields = [Field(spec.out_name, agg.out_type, True)
                      for spec, agg in zip(self.aggs, self._aggregators)]
        self.out_schema = Schema(tuple(fields + agg_fields))

    # -- state: (grouper_state, tuple(agg_states), tuple(unique key Arrays))
    def init_state(self, device=None):
        device = resolve_device(device)
        return (self.grouper.init_state(device),
                tuple(a.init(device) for a in self._aggregators), None)

    def state_from_numpy(self, leaves, device=None):
        """The port's state from a JAX HashAggregate state whose leaves
        were fetched as numpy (``jax.tree_util.tree_map(np.asarray,
        state)``), read by attribute: the grouper state's table_lanes
        (u32 -> int64), table_gid, num_groups and error; the aggregator
        states (nested tuples of arrays); the uniques (Arrays with
        .values / .validity, or None)."""
        gs, aggs, uniques = leaves
        device = resolve_device(device)

        def t(x):
            return torch.from_numpy(np.array(x)).to(device)

        grouper_state = GrouperState(
            t(np.asarray(gs.table_lanes).astype(np.int64)), t(gs.table_gid),
            t(gs.num_groups), t(gs.error))

        us = None
        if uniques is not None:
            us = tuple(Array(f.type, t(u.values),
                             None if u.validity is None else t(u.validity))
                       for u, f in zip(uniques, self.key_fields))
        return (grouper_state,
                tuple(a.state_from_numpy(st, t)
                      for a, st in zip(self._aggregators, aggs)),
                us)

    def consume(self, state, batch: Batch, pack_arrays=None,
                pack_static=None, first: bool = False, lanes=None):
        """One pass: sort-group the batch by key (one sort), run the
        grouper table over the unique reps, then segment-reduce every
        aggregate (ops/segment): the only row-granular ops are the sort,
        the gathers through its permutation and the run reductions; every
        state update writes one element per distinct group.

        ``pack_arrays`` ((lo, shift, outmap) tensors) + ``pack_static``
        ((K, fold)): per-batch sort-key range packing; ``first``: the
        empty-state path (skips the merge-insert table sort). Both come
        from the host routing of ``probe_route``; ``lanes`` the key lanes
        when the probe built them already."""
        pack = None
        if pack_arrays is not None:
            pack = (pack_arrays[0], pack_arrays[1], pack_arrays[2],
                    pack_static[0], pack_static[1])
        grouper_state, agg_states, uniques = state
        key_cols = [batch.column(k) for k in self.keys]
        # aggregate input columns come back in sorted order with the sort,
        # once per column however many aggregates read it
        payload_plan = []   # (buffer id, has_validity)
        payloads = []
        for spec in self.aggs:
            if len(spec.targets) != 1:
                continue
            col = batch.column(spec.targets[0])
            key = id(col.values)
            if col.type.is_varlen or any(key == k for k, _ in payload_plan):
                continue        # a byte pool does not follow a row order
            payload_plan.append((key, col.validity is not None))
            payloads.append(col.values)
            if col.validity is not None:
                payloads.append(col.validity)
        # the per-row group ids (codes) are only needed by aggregators
        # without a segment-consume override
        need_codes = any(
            type(a).consume_grouped is GroupedAggregator.consume_grouped
            for a in self._aggregators)
        grouper_state, rep_gids, g, s_payloads = \
            self.grouper.consume_with_group(
                grouper_state, key_cols, length=batch.length,
                payloads=tuple(payloads), pack=pack, first=first,
                need_codes=need_codes, lanes=lanes)
        sorted_cols = {}
        it = iter(s_payloads)
        for key, has_valid in payload_plan:
            v_sorted = next(it)
            sorted_cols[key] = (v_sorted, next(it) if has_valid else None)
        ctx = make_segment_context(g, rep_gids, sorted_cols)
        uniques = tuple(self.grouper.uniques_scatter_reps(
            key_cols, g, rep_gids, uniques))
        new_agg_states = []
        for spec, agg, st in zip(self.aggs, self._aggregators, agg_states):
            ts = [batch.column(t) for t in spec.targets]
            # several targets reach the aggregator as a tuple
            values = tuple(ts) if len(ts) > 1 else (ts[0] if ts else None)
            new_agg_states.append(agg.consume_grouped(st, values, ctx))
        return (grouper_state, tuple(new_agg_states), uniques)

    # ------------------------------------------------------------------
    # Dense-domain route (the reference's GrouperFastImpl specialization,
    # ``grouper.cc:548``): when the single integer key spans a small
    # domain, gid = key - lo with no grouping sort, every aggregate
    # reduces in one kernel pass, first-appearance group numbering comes
    # from a per-slot first-row reduction, and the per-slot partial states
    # fold into the state through ``merge_rows``.
    def dense_static_ok(self) -> bool:
        """Static (schema-level) eligibility for the dense-domain kernel."""
        if len(self.keys) != 1:
            return False
        if not self.in_schema.field(self.keys[0]).type.is_integer:
            return False
        for agg in self._aggregators:
            if agg.name not in self._DENSE_FNS:
                return False
            it = agg.in_type
            f32 = it is not None and it.is_floating and it.bit_width == 32
            i64 = it is not None and it.is_signed_integer \
                and it.bit_width == 64
            if agg.name == "mean" and not f32:
                return False
            if agg.name in ("sum", "min", "max") and not (f32 or i64):
                return False
            if agg.name in ("any", "all") and not isinstance(
                    it, dt.BoolType):
                return False
        return True

    def probe_scalars(self, batch: Batch, lanes=None):
        """Device scalars for the host routing decision (the caller fetches
        them in one host read): per-lane (lo, span) windows of the key
        lanes (the tighter of the unsigned/signed window) + the dense key
        domain when the dense kernel is statically eligible."""
        key_cols = [batch.column(k) for k in self.keys]
        if lanes is None:
            lanes = group_key_lanes(key_cols, self.grouper.key_nullable)
        lo, span = lane_windows(
            lanes, row_mask(batch.capacity, batch.length, lanes.device))
        out = {"lo": lo, "span": span}
        if self.dense_static_ok():
            out["dlo"], out["dhi"] = _probe_key_domain(key_cols[0])
        return out

    def probe_route(self, batch: Batch, vals):
        """Host routing from fetched ``probe_scalars``: ("dense", cfg) |
        ("packed", params) | ("generic", None), as the JAX package routes.
        ``params`` = (lo, shift, outmap, K, fold) packs the key lanes into
        K 32-bit sort keys (first-fit decreasing); its three tensors lie on
        the batch's device."""
        if "dlo" in vals:
            lo, hi = int(vals["dlo"]), int(vals["dhi"])
            if hi >= lo:
                key = batch.column(self.keys[0])
                needed = (hi - lo + 1) + (
                    1 if key.validity is not None else 0)
                for impl, cap in (("pallas", self.DENSE_CAP),
                                  ("sorted", self.SORTED_DENSE_CAP)):
                    if needed <= min(cap, self.max_groups):
                        G = 128
                        while G < needed:
                            G *= 2
                        return ("dense", {"lo": lo, "G": G, "impl": impl})
        spans = [int(s) for s in np.asarray(vals["span"])]
        los = np.asarray(vals["lo"], dtype=np.uint32)
        L = len(spans)
        bits = [s.bit_length() for s in spans]
        order = sorted(range(L), key=lambda j: -bits[j])
        bin_used: list = []
        outmap = np.zeros((L,), np.int32)
        shifts = np.zeros((L,), np.uint32)
        for j in order:
            for k in range(len(bin_used)):
                if bin_used[k] + bits[j] <= 32:
                    break
            else:
                k = len(bin_used)
                bin_used.append(0)
            outmap[j] = k
            shifts[j] = bin_used[k]
            bin_used[k] += bits[j]
        K = len(bin_used)
        # fold the inactive sentinel into a bin with <= 30 used bits by
        # swapping it to bin 0
        fold = False
        for k in range(K):
            if bin_used[k] <= 30:
                if k != 0:
                    outmap = np.where(outmap == 0, -1, outmap)
                    outmap = np.where(outmap == k, 0, outmap)
                    outmap = np.where(outmap == -1, k, outmap)
                fold = True
                break
        if K + (0 if fold else 1) >= L + 1 or K > 2:
            return ("generic", None)
        dev = batch.device
        return ("packed", (torch.from_numpy(los.astype(np.int64)).to(dev),
                           torch.from_numpy(shifts.astype(np.int64)).to(dev),
                           torch.from_numpy(outmap.astype(np.int32)).to(dev),
                           K, fold))

    def consume_dense(self, state, batch: Batch, lo, G: int,
                      impl: str = "pallas"):
        """Dense-domain consume with ``G`` slots from key ``lo`` up: impl
        "pallas" is the ``dense_group_reduce`` kernel (up to ``DENSE_CAP``
        slots), "sorted" ``sorted_group_reduce`` for larger domains; both
        take the same arguments.

        The kernel reads the columns as they are: the key for the slot (a
        ``DenseKey``: no gid is built), "first_row" for the
        group order, "sum" / "min" / "max" over a float32 column, "sum64" /
        "min64" / "max64" over an int64 column, "any8" / "all8" over a bool
        column, the column's validity as
        the kind's validity stream, two kinds over one column sharing its
        stream. A "count" stream is built only for a column that has nulls
        (else the kernel's row count is the count). The JAX package feeds
        its kernel limb, pair and identity-masked 32-bit streams instead
        (the TPU has no 64-bit arithmetic; any / all as int32 streams
        reduced by imax / imin); the results are the same."""
        if impl not in ("pallas", "sorted"):
            raise ValueError(f"dense impl {impl!r}: 'pallas' or 'sorted'")
        key = batch.column(self.keys[0])
        kdtype = key.values.dtype
        lo = int(lo)
        if kdtype in SIGNED_OF:
            # wide unsigned keys: int64 arithmetic (mod 2^64 for uint64)
            kv64 = unsigned_to_int64(key.values)
            lo = lo - (1 << 64) if lo >= (1 << 63) else lo
        else:
            kv64 = key.values.to(torch.int64)
        # the kernel forms the slot from the key itself: key - lo, the
        # null-key slot G - 1 (the probe reserved it), none past the length
        slots = DenseKey(kv64, lo, batch.length, key.validity)
        kinds, inputs, valid = ["first_row"], [], [None]
        out_of = {}             # sig -> index of the kind (= of its output)

        def add(sig, kind, x, v=None):
            """Register one kind once per signature."""
            if sig not in out_of:
                out_of[sig] = len(kinds)
                kinds.append(kind)
                inputs.append(x)
                valid.append(v)

        def is_i64(agg):
            it = agg.in_type
            return it.is_signed_integer and it.bit_width == 64

        for spec, agg in zip(self.aggs, self._aggregators):
            if agg.name == "count_all":
                continue        # served by the kernel's rows output
            tgt = spec.targets[0]
            col = batch.column(tgt)
            mode = getattr(agg.options, "mode", "only_valid") \
                if agg.name == "count" else "only_valid"
            # a column without nulls needs no count stream: the kernel's
            # rows are its valid count and its null count is 0
            if col.validity is not None and mode == "only_null":
                add((tgt, "count_null"), "count",
                    (~col.validity).to(torch.int32))
            elif col.validity is not None and mode == "only_valid":
                add((tgt, "countv"), "count", col.validity.to(torch.int32))
            if agg.name == "count":
                continue
            if agg.name in ("any", "all"):
                add((tgt, agg.name), agg.name + "8", col.values,
                    col.validity)
            elif is_i64(agg):
                add((tgt, agg.name), agg.name + "64", col.values,
                    col.validity)
            else:
                kind = "sum" if agg.name == "mean" else agg.name
                add((tgt, kind), kind, col.values.to(torch.float32),
                    col.validity)
        reduce = dense_group_reduce if impl == "pallas" \
            else sorted_group_reduce
        rows, outs = reduce(slots, tuple(inputs), tuple(kinds), G,
                            tuple(valid))
        present = rows > 0
        order_key = torch.where(present, outs[0], _I32MAX)
        perm = torch.argsort(order_key, stable=True)  # slots by appearance
        o_count = present.sum(dtype=torch.int32)
        if kdtype in SIGNED_OF:
            # back to the key's type by its low bits
            kvals = (lo + perm).to(SIGNED_OF[kdtype]).view(kdtype)
        else:
            kvals = lo + perm.to(kdtype)
        kvalid = perm != G - 1 if key.validity is not None else None
        o_key = Array(key.type, kvals, kvalid, length=o_count)

        rp = rows[perm].to(torch.int64)

        def out_for(sig):
            return outs[out_of[sig]][perm]

        def count_for(tgt, what):
            """Valid ("countv") or null ("count_null") rows of column
            ``tgt`` per group."""
            if batch.column(tgt).validity is None:
                return rp if what == "countv" else torch.zeros_like(rp)
            return out_for((tgt, what)).to(torch.int64)

        o_states = []
        for spec, agg in zip(self.aggs, self._aggregators):
            if agg.name == "count_all":
                o_states.append(rp)
                continue
            tgt = spec.targets[0]
            if agg.name == "count":
                mode = getattr(agg.options, "mode", "only_valid")
                o_states.append(
                    rp if mode == "all" else count_for(
                        tgt, "count_null" if mode == "only_null"
                        else "countv"))
                continue
            cnt = count_for(tgt, "countv")
            if agg.name in ("sum", "mean") and not is_i64(agg):
                o_states.append((out_for((tgt, "sum")).to(agg._acc_dtype),
                                 cnt))
            elif agg.name in ("any", "all"):
                o_states.append((out_for((tgt, agg.name)) != 0, cnt))
            elif agg.name in ("min", "max"):
                o_states.append((agg.acc_of_values(
                    out_for((tgt, agg.name)), cnt), cnt))
            else:       # int64 sum: as it is
                o_states.append((out_for((tgt, agg.name)), cnt))
        return self.merge_rows(state, [o_key], tuple(o_states), o_count)

    def merge(self, state, other_state):
        """Cross-shard combine: feed the other state's unique keys through
        this grouper to build the group-id mapping, then merge each
        aggregator (the reference's Merge-with-group_id_mapping,
        ``groupby_aggregate_node.cc:255``)."""
        o_grouper_state, o_agg_states, o_uniques = other_state
        if o_uniques is None:           # the other state consumed nothing
            return state
        # slot-form string uniques become varlen Arrays first, so that the
        # grouper keys their content bytes
        o_keys = [u.to_array(f.type) if isinstance(u, SlotStrings) else u
                  for u, f in zip(o_uniques, self.key_fields)]
        return self.merge_rows(state, o_keys, o_agg_states,
                               o_grouper_state.num_groups)

    @property
    def supports_state_exchange(self) -> bool:
        """True when every aggregator's state is one row per group, so the
        distributed combine can exchange pre-aggregated state rows
        (skew-immune) instead of raw input rows."""
        return all(a.dist_rows for a in self._aggregators)

    def merge_rows(self, state, o_keys, o_agg_states, o_count):
        """Fold per-group state ROWS (keys + one state row per group) into
        this state. The rows may come from another state's buffers
        (``merge``) or from an exchange of pre-aggregated shard states
        (``parallel/dist_agg``): any capacity works, and rows past
        ``o_count`` are dropped."""
        grouper_state, agg_states, uniques = state
        grouper_state, mapping = self.grouper.consume(
            grouper_state, o_keys, length=o_count)
        uniques = tuple(self.grouper.uniques_scatter(
            o_keys, mapping, uniques))
        # inactive rows (gid -1) go to the dropped index max_groups
        mapping = torch.where(mapping < 0, self.max_groups, mapping)
        new_agg_states = tuple(
            agg.merge(st, ost, mapping)
            for agg, st, ost in zip(self._aggregators, agg_states,
                                    o_agg_states))
        return (grouper_state, new_agg_states, uniques)

    def finalize(self, state) -> Batch:
        grouper_state, agg_states, uniques = state
        n = grouper_state.num_groups
        dev = grouper_state.table_gid.device
        if uniques is None:
            uniques = [
                SlotStrings.init(self.max_groups,
                                 self.grouper.varlen_slot_bytes, dev)
                if f.type.is_varlen else
                Array(f.type, torch.from_numpy(np.zeros(
                    (self.max_groups,) + value_row_shape(f.type),
                    f.type.storage_np)).to(dev),
                    dictionary=nulls(0, f.type.value_type, device=dev)
                    if isinstance(f.type, dt.DictionaryType) else None)
                for f in self.key_fields]
        arrays = [u.to_array(f.type, length=n)
                  if isinstance(u, SlotStrings) else u.with_length(n)
                  for u, f in zip(uniques, self.key_fields)]
        for agg, st in zip(self._aggregators, agg_states):
            arrays.append(agg.finalize(st, n))
        return Batch(self.out_schema, arrays, n)

    def error_flags(self, state) -> list:
        """[(carrier, 0-d int32 flag on the device)] of the deferred errors
        beyond the group table's: each aggregator with an ``error_flag``
        (a full tdigest buffer, a full count_distinct pair table) and each
        varlen key's unique slots (a key longer than its slot). A carrier
        has ``error_message(flag)``."""
        _, agg_states, uniques = state
        out = [(agg, agg.error_flag(st).reshape(()).to(torch.int32))
               for agg, st in zip(self._aggregators, agg_states)
               if hasattr(agg, "error_flag")]
        out += [(_SlotOverflow(f.name, self.grouper.varlen_slot_bytes),
                 u.error.reshape(()).to(torch.int32))
                for u, f in zip(uniques or (), self.key_fields)
                if isinstance(u, SlotStrings)]
        return out

    def aggregator_errors(self, state):
        """Host-side deferred errors beyond the group table's:
        [(carrier, nonzero flag)] (``error_flags``). One host read."""
        carriers = self.error_flags(state)
        if not carriers:
            return []
        flags = torch.stack([f for _, f in carriers]).cpu().tolist()
        return [(c, flag) for (c, _), flag in zip(carriers, flags) if flag]
