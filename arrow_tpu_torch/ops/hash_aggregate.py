"""Grouped hash aggregation: Grouper + GroupedAggregators glued together.

Reference: ``GroupByNode`` (``acero/groupby_aggregate_node.cc``; Consume
:210, Merge :255, Finalize :300). The counterpart of the JAX package's
``ops/hash_aggregate.py``. One probe of the key range on the host picks
the route (``probe_route``):

  * "dense" when the single integer key spans a small domain:
    ``consume_dense`` reduces every aggregate in one pass of the
    ``dense_group_reduce`` CUDA kernel and folds the per-slot partials into
    the state through ``merge_rows``;
  * "packed" / "generic": ``consume`` sort-groups the batch by key (the key
    lanes range-packed into fewer sort keys where the probe allows), runs
    the grouper table over the unique reps and segment-reduces every
    aggregate (``ops/segment``).

A route this package does not run (the sorted dense reduction) raises
``NotImplementedError`` in its caller.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.array import Array, resolve_device, row_mask
from ..core.batch import Batch
from ..core.schema import Field, Schema
from .aggregates import GroupedAggregator, make_grouped_aggregator
from .bits import U32
from .cuda_kernels import dense_group_reduce
from .grouper import Grouper, GrouperState, group_key_lanes
from .segment import make_segment_context

__all__ = ["AggregateSpec", "HashAggregate"]

_I32MAX = (1 << 31) - 1
_I32MIN = -(1 << 31)
_I64MIN = -(1 << 63)
_BIAS32 = 0x80000000


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


def _probe_key_domain(key: Array):
    """(min, max) of the key over active (in-range, non-null) rows; if no
    active rows, min > max."""
    act = key.present_mask()
    v = key.values
    info = torch.iinfo(v.dtype)
    lo = torch.where(act, v, info.max).min()
    hi = torch.where(act, v, info.min).max()
    return lo, hi


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> the int32 with the same bits."""
    return ((x & U32) ^ _BIAS32) - _BIAS32


class HashAggregate:
    """Static-config grouped aggregation over a stream of batches."""

    # dense-slot caps of the JAX package's routing (DENSE_CAP for the
    # kernel, SORTED_DENSE_CAP for the sorted dense reduction), so that
    # both packages route a batch alike
    DENSE_CAP = 4096
    SORTED_DENSE_CAP = 1 << 20
    _DENSE_FNS = {"count", "count_all", "sum", "mean", "min", "max"}

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
            ts = spec.targets
            in_type = in_schema.field(ts[0]).type if ts else None
            self._aggregators.append(make_grouped_aggregator(
                spec.function, in_type, max_groups, spec.options))
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

        def conv(x):
            return tuple(conv(y) for y in x) if isinstance(x, tuple) \
                else t(x)
        us = None
        if uniques is not None:
            us = tuple(Array(f.type, t(u.values),
                             None if u.validity is None else t(u.validity))
                       for u, f in zip(uniques, self.key_fields))
        return (grouper_state, conv(tuple(aggs)), us)

    def consume(self, state, batch: Batch, pack_arrays=None,
                pack_static=None, first: bool = False):
        """One pass: sort-group the batch by key (one sort), run the
        grouper table over the unique reps, then segment-reduce every
        aggregate (ops/segment): the only row-granular ops are the sort,
        the gathers through its permutation and the run reductions; every
        state update writes one element per distinct group.

        ``pack_arrays`` ((lo, shift, outmap) tensors) + ``pack_static``
        ((K, fold)): per-batch sort-key range packing; ``first``: the
        empty-state path (skips the merge-insert table sort). Both come
        from the host routing of ``probe_route``."""
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
            if any(key == k for k, _ in payload_plan):
                continue
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
                need_codes=need_codes)
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
            ts = spec.targets
            values = batch.column(ts[0]) if ts else None
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
        return True

    def probe_scalars(self, batch: Batch):
        """Device scalars for the host routing decision (the caller fetches
        them in one host read): per-lane (lo, span) windows of the key
        lanes (the tighter of the unsigned/signed window) + the dense key
        domain when the dense kernel is statically eligible."""
        key_cols = [batch.column(k) for k in self.keys]
        lanes = group_key_lanes(key_cols, self.grouper.key_nullable)
        act2 = row_mask(batch.capacity, batch.length, lanes.device)[:, None]
        lo_u = torch.where(act2, lanes, U32).min(dim=0).values
        hi_u = torch.where(act2, lanes, 0).max(dim=0).values
        span_u = (hi_u - lo_u) & U32
        lanes_i = _as_i32(lanes)
        lo_i = torch.where(act2, lanes_i, _I32MAX).min(dim=0).values
        hi_i = torch.where(act2, lanes_i, _I32MIN).max(dim=0).values
        span_i = (hi_i - lo_i) & U32
        use_i = span_i < span_u
        out = {"lo": torch.where(use_i, lo_i & U32, lo_u),
               "span": torch.minimum(span_i, span_u)}
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
        """Dense-domain consume with ``G`` slots from key ``lo`` up. Only
        impl "pallas" (the ``dense_group_reduce`` kernel) is ported; the
        sorted dense reduction for larger domains comes later."""
        if impl != "pallas":
            raise NotImplementedError(f"dense impl {impl!r}")
        key = batch.column(self.keys[0])
        cap = key.capacity
        dev = key.device
        in_range = row_mask(cap, batch.length, dev)
        kv = (key.values - lo).to(torch.int32)
        gid = torch.where(in_range, kv, -1).to(torch.int32)
        if key.validity is not None:
            # null key rows form their own group in slot G-1 (the probe
            # reserved it)
            gid = torch.where(key.validity | ~in_range, gid, G - 1)
        iota = torch.arange(cap, dtype=torch.int32, device=dev)
        inputs = [torch.where(gid >= 0, iota, _I32MAX)]
        kinds = ["imin"]
        slot_of = {}            # sig -> kind-entry index

        def add(sig, build):
            """Register one kind entry (1+ inputs) once per signature."""
            if sig not in slot_of:
                slot_of[sig] = len(kinds)
                xs, kind = build()
                inputs.extend(xs if isinstance(xs, (list, tuple))
                              else [xs])
                kinds.append(kind)

        def _i64_limbs(v, ok):
            """int64 -> four 16-bit limbs of the SIGN-BIASED value (u32
            wrap + carry accumulation in the kernel is exact mod 2^64)."""
            u = v ^ _I64MIN
            return [torch.where(ok, (u >> (16 * k)) & 0xFFFF, 0)
                    .to(torch.int32) for k in range(4)]

        def _i64_pair(v, ok, is_min):
            ident = _I32MAX if is_min else _I32MIN
            hi = (v >> 32).to(torch.int32)
            lo_b = ((v & U32) - _BIAS32).to(torch.int32)
            return [torch.where(ok, hi, ident), torch.where(ok, lo_b, ident)]

        def i32(x):
            return x.to(torch.int32)

        def is_i64(agg):
            it = agg.in_type
            return it.is_signed_integer and it.bit_width == 64

        active = gid >= 0
        for spec, agg in zip(self.aggs, self._aggregators):
            if agg.name == "count_all":
                continue        # served by the kernel's rows output
            col = batch.column(spec.targets[0])
            ok = active if col.validity is None else (active & col.validity)
            tgt = spec.targets[0]
            if agg.name == "count":
                mode = getattr(agg.options, "mode", "only_valid")
                if mode == "only_null":
                    okn = active & ~col.validity_or_true()
                    add((tgt, "count_null"), lambda okn=okn: (i32(okn),
                                                              "count"))
                elif mode == "all":
                    add((None, "rows"), lambda: (i32(active), "count"))
                else:
                    add((tgt, "countv"), lambda ok=ok: (i32(ok), "count"))
                continue
            add((tgt, "countv"), lambda ok=ok: (i32(ok), "count"))
            if is_i64(agg):
                v = col.values
                if agg.name == "sum":
                    add((tgt, "sum64"),
                        lambda v=v, ok=ok: (_i64_limbs(v, ok), "sumc"))
                elif agg.name in ("min", "max"):
                    is_min = agg.name == "min"
                    add((tgt, agg.name + "64"), lambda v=v, ok=ok, m=is_min:
                        (_i64_pair(v, ok, m), "imin64" if m else "imax64"))
                continue
            v = col.values.to(torch.float32)
            if agg.name in ("sum", "mean"):
                add((tgt, "sum"), lambda v=v, ok=ok: (
                    torch.where(ok, v, 0.0), "sum"))
            elif agg.name == "min":
                add((tgt, "min"), lambda v=v, ok=ok: (
                    torch.where(ok, v, float("inf")), "min"))
            elif agg.name == "max":
                add((tgt, "max"), lambda v=v, ok=ok: (
                    torch.where(ok, v, float("-inf")), "max"))

        # int64 sums need FOUR sumc entries (one per limb); expand the
        # single "sumc" marker into the real kind list
        flat_kinds = []
        entry_first_out = []    # kind-entry index -> first output index
        out_pos = 0
        for k in kinds:
            entry_first_out.append(out_pos)
            if k == "sumc":
                flat_kinds.extend(["sumc"] * 4)
                out_pos += 8
            else:
                flat_kinds.append(k)
                out_pos += 2 if k in ("imin64", "imax64") else 1
        rows, outs = dense_group_reduce(gid, tuple(inputs),
                                        tuple(flat_kinds), G)
        present = rows > 0
        order_key = torch.where(present, outs[0], _I32MAX)
        perm = torch.argsort(order_key, stable=True)  # slots by appearance
        o_count = present.sum(dtype=torch.int32)
        kvals = lo + perm.to(key.values.dtype)
        kvalid = perm != G - 1 if key.validity is not None else None
        o_key = Array(key.type, kvals, kvalid, length=o_count)

        def outs_for(sig, n):
            base = entry_first_out[slot_of[sig]]
            return [outs[base + j][perm] for j in range(n)]

        rp = rows[perm].to(torch.int64)
        o_states = []
        for spec, agg in zip(self.aggs, self._aggregators):
            if agg.name == "count_all":
                o_states.append(rp)
                continue
            tgt = spec.targets[0]
            if agg.name == "count":
                mode = getattr(agg.options, "mode", "only_valid")
                sig = {"only_null": (tgt, "count_null"),
                       "all": (None, "rows")}.get(mode, (tgt, "countv"))
                o_states.append(outs_for(sig, 1)[0].to(torch.int64))
                continue
            cnt = outs_for((tgt, "countv"), 1)[0].to(torch.int64)
            if is_i64(agg) and agg.name == "sum":
                parts = outs_for((tgt, "sum64"), 8)
                total = torch.zeros_like(cnt)
                for k in range(4):
                    limb = (parts[2 * k + 1].long() << 32) | \
                        (parts[2 * k].long() & U32)
                    total = total + (limb << (16 * k))   # wraps mod 2^64
                # un-bias: subtract count * 2^63 (mod 2^64)
                o_states.append((total - (cnt << 63), cnt))
            elif is_i64(agg):                              # min / max
                hi, lo_b = outs_for((tgt, agg.name + "64"), 2)
                val = (hi.long() << 32) | ((lo_b.long() & U32) ^ _BIAS32)
                o_states.append((val, cnt))
            elif agg.name in ("sum", "mean"):
                o_states.append((outs_for((tgt, "sum"), 1)[0]
                                 .to(agg._acc_dtype), cnt))
            else:                                          # f32 min / max
                o_states.append((outs_for((tgt, agg.name), 1)[0], cnt))
        return self.merge_rows(state, [o_key], tuple(o_states), o_count)

    def merge_rows(self, state, o_keys, o_agg_states, o_count):
        """Fold per-group state ROWS (keys + one state row per group) into
        this state; rows past ``o_count`` are dropped."""
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
            uniques = [Array(f.type, torch.from_numpy(np.zeros(
                (self.max_groups,), f.type.storage_np)).to(dev))
                for f in self.key_fields]
        arrays = [u.with_length(n) for u in uniques]
        for agg, st in zip(self._aggregators, agg_states):
            arrays.append(agg.finalize(st, n))
        return Batch(self.out_schema, arrays, n)
