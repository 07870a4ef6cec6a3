"""Grouped aggregators: the init / consume / merge / finalize protocol.

Reference: the GroupedAggregator state protocol
(``hash_aggregate_internal.h:39-58``: Resize/Consume(values, group_ids)/
Merge(other, group_id_mapping)/Finalize); the counterpart of the JAX
package's ``ops/aggregates.py`` for count, count_all, sum, mean, min and
max. States are fixed-capacity (max_groups,) tensors. ``consume`` folds
rows into the state by their group id; ``consume_grouped`` reduces each
run of a sort-grouped batch (``ops/segment``) and writes one element per
distinct group; ``merge`` folds another state's group g into this state's
group mapping[g]. Positions equal to the capacity are dropped (the JAX
``mode="drop"``), through one extra dump slot that is sliced off.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import datatype as dt
from ..core.array import Array
from .agg_options import CountOptions
from .kernel_utils import torch_dtype
from .segment import extreme_identity, seg_reduce_max, seg_reduce_min, \
    seg_sum

__all__ = ["GroupedAggregator", "make_grouped_aggregator",
           "GROUPED_AGGREGATORS"]


def _sum_output_type(t: dt.DataType) -> dt.DataType:
    if t.is_floating:
        return t
    if isinstance(t, dt.BoolType):
        return dt.uint64
    if t.is_signed_integer:
        return dt.int64
    return dt.uint64


def _fold(state: torch.Tensor, mapping: torch.Tensor, other: torch.Tensor,
          ident, reduce: Optional[str] = None) -> torch.Tensor:
    """state[mapping] (+)= other, by add or by ``reduce`` ("amin"/"amax"),
    with mapping == len(state) dropped."""
    G = state.shape[0]
    ext = torch.cat([state, state.new_full((1,), ident)])
    idx = mapping.long()
    if reduce is None:
        ext.index_add_(0, idx, other.to(state.dtype))
    else:
        ext.scatter_reduce_(0, idx, other.to(state.dtype), reduce)
    return ext[:G]


def _contrib_mask(values: Array, group_ids: torch.Tensor) -> torch.Tensor:
    """Rows that contribute: in a group AND valid (skip_nulls)."""
    m = group_ids >= 0
    if values.validity is not None:
        m = m & values.validity
    return m


def _positions(mask: torch.Tensor, group_ids: torch.Tensor, G: int
               ) -> torch.Tensor:
    """Fold positions: group id, or G (dropped) for non-contributors."""
    return torch.where(mask, group_ids, G)


def _sorted_inputs(values: Optional[Array], ctx):
    """(values in sorted order | None, contribution flags in sorted order).
    skip_nulls semantics: a row contributes iff active AND valid. Columns
    that rode the grouping sort as payloads come from ctx.sorted_cols;
    others gather through perm."""
    ok = ctx.s_active
    v_sorted = None
    if values is not None:
        cached = ctx.sorted_cols.get(id(values.values))
        if cached is not None:
            v_sorted, valid_sorted = cached
        else:
            v_sorted = values.values[ctx.perm]
            valid_sorted = None if values.validity is None \
                else values.validity[ctx.perm]
        if valid_sorted is not None:
            ok = ok & valid_sorted
    return v_sorted, ok


def _gpos(ctx, G: int) -> torch.Tensor:
    """(R,) fold targets: persistent gid per run, G for pads — unique by
    construction (one write per distinct group)."""
    return torch.where(ctx.gid_global >= 0, ctx.gid_global, G)


def _count_mode(options) -> str:
    return options.mode if isinstance(options, CountOptions) \
        else "only_valid"


class GroupedAggregator:
    """Base class. Subclasses define init/consume/merge/finalize."""

    name: str = ""
    # the state is one row per group (tensors of max_groups rows), so a
    # distributed combine can exchange state ROWS between shards
    dist_rows: bool = True

    def __init__(self, in_type: Optional[dt.DataType], G: int, options=None):
        self.in_type = in_type
        self.G = G
        self.options = options

    def init(self, device=None):
        raise NotImplementedError

    def consume(self, state, values: Optional[Array],
                group_ids: torch.Tensor):
        """Fold the rows of ``values`` into the groups ``group_ids`` names
        (-1 = no group)."""
        raise NotImplementedError

    def merge(self, state, other, mapping: torch.Tensor):
        """Fold `other`'s group g into this state's group mapping[g]."""
        raise NotImplementedError

    def consume_grouped(self, state, values: Optional[Array], ctx):
        """Segment-reduction consume over a sort-grouped batch
        (ops/segment.SegmentContext). The default is the row consume (it
        needs ctx.row_gids); the aggregators below override it with run
        reductions that write one element per distinct group."""
        return self.consume(state, values, ctx.row_gids)

    def finalize(self, state, num_groups) -> Array:
        raise NotImplementedError


class GroupedCount(GroupedAggregator):
    """hash_count (``hash_aggregate.cc:108``); CountOptions modes."""

    name = "count"
    out_type = dt.int64

    def init(self, device=None):
        return torch.zeros((self.G,), dtype=torch.int64, device=device)

    def _counted(self, values, in_group: torch.Tensor, validity):
        """Rows the count mode counts: ``validity`` is the column's, laid
        out like ``in_group`` (None = all valid)."""
        mode = _count_mode(self.options)
        if values is None or validity is None:
            return in_group if mode != "only_null" \
                else torch.zeros_like(in_group)
        if mode == "only_valid":
            return in_group & validity
        if mode == "only_null":
            return in_group & ~validity
        return in_group

    def consume(self, state, values, group_ids):
        ok = self._counted(values, group_ids >= 0,
                           None if values is None else values.validity)
        return _fold(state, _positions(ok, group_ids, self.G),
                     ok.to(torch.int64), 0)

    def merge(self, state, other, mapping):
        return _fold(state, mapping, other, 0)

    def consume_grouped(self, state, values, ctx):
        validity = None
        if values is not None and values.validity is not None:
            cached = ctx.sorted_cols.get(id(values.values))
            validity = cached[1] if cached is not None \
                else values.validity[ctx.perm]
        ok = self._counted(values, ctx.s_active, validity)
        return _fold(state, _gpos(ctx, self.G),
                     seg_sum(ctx, ok.to(torch.int64)), 0)

    def finalize(self, state, num_groups) -> Array:
        return Array(dt.int64, state, None, length=num_groups)


class GroupedCountAll(GroupedCount):
    """hash_count_all (``hash_aggregate.cc:62``) — nullary, counts rows."""

    name = "count_all"

    def consume(self, state, values, group_ids):
        ok = group_ids >= 0
        return _fold(state, _positions(ok, group_ids, self.G),
                     ok.to(torch.int64), 0)

    def consume_grouped(self, state, values, ctx):
        return _fold(state, _gpos(ctx, self.G),
                     seg_sum(ctx, ctx.s_active.to(torch.int64)), 0)


class GroupedSum(GroupedAggregator):
    """hash_sum (``hash_aggregate_numeric.cc:275``)."""

    name = "sum"

    @property
    def out_type(self):
        return _sum_output_type(self.in_type)

    @property
    def _acc_dtype(self) -> torch.dtype:
        """The accumulator's dtype. Unsigned sums (uint64 out) are held as
        the int64 with the same bits: torch can neither cumsum nor
        index_add a uint64, and two's-complement addition is the same
        addition mod 2^64; ``finalize`` views the bits as uint64."""
        d = torch_dtype(self.out_type)
        return torch.int64 if d == torch.uint64 else d

    def _to_acc(self, v: torch.Tensor) -> torch.Tensor:
        if v.dtype == torch.uint64:
            return v.view(torch.int64)
        return v.to(self._acc_dtype)

    def init(self, device=None):
        return (torch.zeros((self.G,), dtype=self._acc_dtype, device=device),
                torch.zeros((self.G,), dtype=torch.int64, device=device))

    def consume(self, state, values, group_ids):
        acc, cnt = state
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        v = torch.where(ok, self._to_acc(values.values), 0)
        return (_fold(acc, pos, v, 0), _fold(cnt, pos, ok.to(torch.int64), 0))

    def merge(self, state, other, mapping):
        acc, cnt = state
        oacc, ocnt = other
        return (_fold(acc, mapping, oacc, 0), _fold(cnt, mapping, ocnt, 0))

    def consume_grouped(self, state, values, ctx):
        acc, cnt = state
        v_sorted, ok = _sorted_inputs(values, ctx)
        x = torch.where(ok, self._to_acc(v_sorted), 0)
        gp = _gpos(ctx, self.G)
        return (_fold(acc, gp, seg_sum(ctx, x), 0),
                _fold(cnt, gp, seg_sum(ctx, ok.to(torch.int64)), 0))

    def finalize(self, state, num_groups) -> Array:
        acc, cnt = state
        if self.out_type == dt.uint64:
            acc = acc.view(torch.uint64)
        # all-null / empty group -> null (Arrow: sum of no rows is null)
        return Array(self.out_type, acc, cnt > 0, length=num_groups)


class GroupedMean(GroupedSum):
    """hash_mean (``hash_aggregate_numeric.cc:360``) — always float64 out."""

    name = "mean"
    out_type = dt.float64

    @property
    def _acc_dtype(self) -> torch.dtype:
        return torch.float64

    def _to_acc(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.float64)

    def finalize(self, state, num_groups) -> Array:
        acc, cnt = state
        mean = acc / torch.where(cnt > 0, cnt, 1).to(torch.float64)
        return Array(dt.float64, mean, cnt > 0, length=num_groups)


class _GroupedExtremum(GroupedAggregator):
    is_min = True

    @property
    def out_type(self):
        return self.in_type

    def _identity(self, dtype: torch.dtype):
        return extreme_identity(dtype, self.is_min)

    def _dtype(self) -> torch.dtype:
        d = torch_dtype(self.in_type)
        return torch.uint8 if d == torch.bool else d

    def init(self, device=None):
        d = self._dtype()
        return (torch.full((self.G,), self._identity(d), dtype=d,
                           device=device),
                torch.zeros((self.G,), dtype=torch.int64, device=device))

    @property
    def _reduce(self) -> str:
        # scatter_reduce amin/amax propagate NaN, as jnp's scatter-min does
        return "amin" if self.is_min else "amax"

    def consume(self, state, values, group_ids):
        acc, cnt = state
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        ident = self._identity(acc.dtype)
        v = torch.where(ok, values.values.to(acc.dtype), ident)
        return (_fold(acc, pos, v, ident, self._reduce),
                _fold(cnt, pos, ok.to(torch.int64), 0))

    def merge(self, state, other, mapping):
        acc, cnt = state
        oacc, ocnt = other
        acc = _fold(acc, mapping, oacc, self._identity(acc.dtype),
                    self._reduce)
        return acc, _fold(cnt, mapping, ocnt, 0)

    def consume_grouped(self, state, values, ctx):
        acc, cnt = state
        v_sorted, ok = _sorted_inputs(values, ctx)
        ident = self._identity(acc.dtype)
        x = torch.where(ok, v_sorted.to(acc.dtype), ident)
        partial = seg_reduce_min(ctx, x) if self.is_min else \
            seg_reduce_max(ctx, x)
        gp = _gpos(ctx, self.G)
        return (_fold(acc, gp, partial, ident, self._reduce),
                _fold(cnt, gp, seg_sum(ctx, ok.to(torch.int64)), 0))

    def finalize(self, state, num_groups) -> Array:
        acc, cnt = state
        out = acc.to(torch.bool) if isinstance(self.in_type, dt.BoolType) \
            else acc
        return Array(self.in_type, out, cnt > 0, length=num_groups)


class GroupedMin(_GroupedExtremum):
    name = "min"
    is_min = True


class GroupedMax(_GroupedExtremum):
    name = "max"
    is_min = False


GROUPED_AGGREGATORS = {
    a.name: a for a in (GroupedCount, GroupedCountAll, GroupedSum,
                        GroupedMean, GroupedMin, GroupedMax)
}


def make_grouped_aggregator(name: str, in_type: Optional[dt.DataType],
                            max_groups: int, options=None
                            ) -> GroupedAggregator:
    key = name[5:] if name.startswith("hash_") else name
    if key not in GROUPED_AGGREGATORS:
        raise KeyError(f"no grouped aggregator named {name!r}")
    return GROUPED_AGGREGATORS[key](in_type, max_groups, options)
