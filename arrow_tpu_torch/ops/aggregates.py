"""Grouped aggregators (the init / consume / merge / finalize protocol) and
the whole-array (scalar) aggregate functions.

Reference: the GroupedAggregator state protocol
(``hash_aggregate_internal.h:39-58``: Resize/Consume(values, group_ids)/
Merge(other, group_id_mapping)/Finalize); the counterpart of the JAX
package's ``ops/aggregates.py``, with its 19 grouped aggregators, the
decimal sum and the scalar aggregates. States are fixed-capacity
(max_groups,) tensors. ``consume`` folds rows into the state by their group
id; ``consume_grouped`` reduces each run of a sort-grouped batch
(``ops/segment``) and writes one element per distinct group; ``merge``
folds another state's group g into this state's group mapping[g]; several
of its groups may map to one. Positions equal to the capacity are dropped
(the JAX ``mode="drop"``), through one extra dump slot that is sliced off.

Where the port departs from the JAX package (ROADMAP C25-C27):
  * variance, stddev, skew and kurtosis keep mean-centred moments
    (count, mean, M2[, M3, M4]): a batch's rows are centred on their
    group's mean (refined once), and partial moments combine
    by the exact shift of each partial's moments to the combined mean
    (Chan's and Pebay's pairwise updates, for any number of partials). The
    JAX package keeps raw power sums, which cancel catastrophically when
    the mean is large against the spread (C27);
  * ``tdigest`` / ``approximate_median`` and ``count_distinct`` report a
    full buffer or pair table through ``error_flag``, which the callers
    check (``HashAggregate.aggregator_errors``); the JAX package's never
    reach a caller (C25, C26).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function, \
    registry
from ..compute.scalar import Scalar
from .agg_options import CountOptions, ScalarAggregateOptions, \
    VarianceOptions
from .bits import FLOAT_KEY, SIGNED_OF, U32, as_signed_bits, \
    float_extreme_key, float_from_extreme_key, from_ordered_signed, \
    gather_rows, ordered_signed, unsigned_to_int64
from .kernel_utils import torch_dtype
from .segment import extreme_identity, seg_all, seg_any, seg_first_row, \
    seg_last_row, seg_prod, seg_reduce_max, seg_reduce_min, seg_sum

__all__ = ["GroupedAggregator", "make_grouped_aggregator",
           "GROUPED_AGGREGATORS", "ScalarAggregateOptions", "CountOptions",
           "VarianceOptions"]


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
    with mapping >= len(state) dropped."""
    G = state.shape[0]
    ext = torch.cat([state, state.new_full((1,), ident)])
    # past a full group table gids reach G and beyond: dropped, as JAX's
    # mode="drop" drops every index out of range
    idx = torch.clamp(mapping.long(), max=G)
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
            v_sorted = gather_rows(values.values, ctx.perm)
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

    def acc_from_numpy(self, acc):
        """The port's accumulator (first state leaf, numpy) from the JAX
        package's: the same array unless the port holds it otherwise."""
        return acc

    def acc_to_numpy(self, acc):
        """Inverse of ``acc_from_numpy``."""
        return acc

    def state_from_numpy(self, st, tensor):
        """The port's state from the JAX package's state ``st`` (numpy
        leaves: a tuple, or one array), each leaf made a tensor by
        ``tensor``."""
        if isinstance(st, tuple):
            return (tensor(self.acc_from_numpy(np.asarray(st[0]))),) + \
                tuple(tensor(x) for x in st[1:])
        return tensor(st)

    def state_to_numpy(self, st) -> list:
        """The JAX package's state leaves (numpy, in its order) of the
        port's row-shaped state ``st``."""
        leaves = [x.cpu().numpy() for x in
                  (st if isinstance(st, tuple) else (st,))]
        if isinstance(st, tuple):
            leaves[0] = self.acc_to_numpy(leaves[0])
        return leaves


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
        if v.dtype in SIGNED_OF:
            return unsigned_to_int64(v)
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

    def acc_from_numpy(self, acc):
        return acc.view(np.int64) if acc.dtype == np.uint64 else acc

    def acc_to_numpy(self, acc):
        return acc.view(np.uint64) if self.out_type == dt.uint64 else acc

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
    """min / max. The accumulator has the column's dtype, except that a
    uint16 / uint32 / uint64 column is held as its ordered signed value
    (``bits.ordered_signed``; torch reduces no wide unsigned type), a bool
    column as uint8, and a float column as its order-preserving keys
    (``bits.float_extreme_key``): NaN is skipped as pyarrow skips it, and
    a group of NaNs alone gives NaN (the JAX package's NaN wins every
    min and max); ``finalize`` turns all three back."""

    is_min = True

    @property
    def out_type(self):
        return self.in_type

    def _identity(self, dtype: torch.dtype):
        return extreme_identity(dtype, self.is_min)

    def _dtype(self) -> torch.dtype:
        d = torch_dtype(self.in_type)
        if d in FLOAT_KEY:
            return FLOAT_KEY[d]
        return torch.uint8 if d == torch.bool else SIGNED_OF.get(d, d)

    def _to_acc(self, v: torch.Tensor) -> torch.Tensor:
        if v.dtype in SIGNED_OF:
            return ordered_signed(v)
        if v.dtype in FLOAT_KEY:
            return float_extreme_key(v, self.is_min)
        return v.to(self._dtype())

    def acc_of_values(self, v: torch.Tensor, cnt: torch.Tensor
                      ) -> torch.Tensor:
        """The accumulator of per-group results ``v`` over ``cnt`` valid
        rows (the dense route's, the JAX package's): a group without a
        valid row holds the identity."""
        acc = self._to_acc(v)
        return torch.where(cnt > 0, acc, self._identity(acc.dtype))

    def state_from_numpy(self, st, tensor):
        v, cnt = tensor(np.asarray(st[0])), tensor(np.asarray(st[1]))
        if v.dtype in SIGNED_OF:
            return ordered_signed(v), cnt
        return self.acc_of_values(v, cnt), cnt

    def acc_to_numpy(self, acc):
        want = np.dtype(self.in_type.storage_np)
        if want.kind == "u" and want.itemsize > 1:
            return (acc ^ np.iinfo(acc.dtype).min).view(want)
        if want.kind == "f":
            return float_from_extreme_key(torch.from_numpy(acc), self.is_min,
                                          torch_dtype(self.in_type)).numpy()
        return acc

    def init(self, device=None):
        d = self._dtype()
        return (torch.full((self.G,), self._identity(d), dtype=d,
                           device=device),
                torch.zeros((self.G,), dtype=torch.int64, device=device))

    @property
    def _reduce(self) -> str:
        return "amin" if self.is_min else "amax"

    def consume(self, state, values, group_ids):
        acc, cnt = state
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        ident = self._identity(acc.dtype)
        v = torch.where(ok, self._to_acc(values.values), ident)
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
        x = torch.where(ok, self._to_acc(v_sorted), ident)
        partial = seg_reduce_min(ctx, x) if self.is_min else \
            seg_reduce_max(ctx, x)
        gp = _gpos(ctx, self.G)
        return (_fold(acc, gp, partial, ident, self._reduce),
                _fold(cnt, gp, seg_sum(ctx, ok.to(torch.int64)), 0))

    def finalize(self, state, num_groups) -> Array:
        acc, cnt = state
        d = torch_dtype(self.in_type)
        if d in SIGNED_OF:
            out = from_ordered_signed(acc, d)
        elif d in FLOAT_KEY:
            out = float_from_extreme_key(acc, self.is_min, d)
        else:
            out = acc.to(torch.bool) if d == torch.bool else acc
        return Array(self.in_type, out, cnt > 0, length=num_groups)


class GroupedMin(_GroupedExtremum):
    name = "min"
    is_min = True


class GroupedMax(_GroupedExtremum):
    name = "max"
    is_min = False


class GroupedProduct(GroupedSum):
    """hash_product (``hash_aggregate_numeric.cc``): the product of the
    valid values, in the sum's output type (integers wrap mod 2^64)."""

    name = "product"

    def init(self, device=None):
        return (torch.ones((self.G,), dtype=self._acc_dtype, device=device),
                torch.zeros((self.G,), dtype=torch.int64, device=device))

    def consume(self, state, values, group_ids):
        acc, cnt = state
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        v = torch.where(ok, self._to_acc(values.values), 1)
        return (_fold(acc, pos, v, 1, "prod"),
                _fold(cnt, pos, ok.to(torch.int64), 0))

    def merge(self, state, other, mapping):
        acc, cnt = state
        oacc, ocnt = other
        return (_fold(acc, mapping, oacc, 1, "prod"),
                _fold(cnt, mapping, ocnt, 0))

    def consume_grouped(self, state, values, ctx):
        acc, cnt = state
        v_sorted, ok = _sorted_inputs(values, ctx)
        x = torch.where(ok, self._to_acc(v_sorted), 1)
        gp = _gpos(ctx, self.G)
        return (_fold(acc, gp, seg_prod(ctx, x), 1, "prod"),
                _fold(cnt, gp, seg_sum(ctx, ok.to(torch.int64)), 0))


class _GroupedBoolean(GroupedAggregator):
    """hash_any / hash_all (``hash_aggregate.cc:1224``): state (acc bool,
    valid count); a group with no valid value is null. The fold runs on
    uint8 (torch reduces no bool)."""

    out_type = dt.bool_
    is_any = True

    @property
    def _reduce(self) -> str:
        return "amax" if self.is_any else "amin"

    def init(self, device=None):
        return (torch.full((self.G,), not self.is_any, dtype=torch.bool,
                           device=device),
                torch.zeros((self.G,), dtype=torch.int64, device=device))

    def _fold_acc(self, acc, at, flags):
        return _fold(acc.to(torch.uint8), at, flags.to(torch.uint8),
                     0 if self.is_any else 1, self._reduce).to(torch.bool)

    def _flags(self, v, ok):
        """Each row's contribution: the value where it counts, else the
        identity."""
        v = v.to(torch.bool)
        return v & ok if self.is_any else v | ~ok

    def consume(self, state, values, group_ids):
        acc, cnt = state
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        return (self._fold_acc(acc, pos, self._flags(values.values, ok)),
                _fold(cnt, pos, ok.to(torch.int64), 0))

    def merge(self, state, other, mapping):
        acc, cnt = state
        oacc, ocnt = other
        return (self._fold_acc(acc, mapping, oacc),
                _fold(cnt, mapping, ocnt, 0))

    def consume_grouped(self, state, values, ctx):
        acc, cnt = state
        v_sorted, ok = _sorted_inputs(values, ctx)
        flags = self._flags(v_sorted, ok)
        partial = seg_any(ctx, flags) if self.is_any else seg_all(ctx, flags)
        gp = _gpos(ctx, self.G)
        return (self._fold_acc(acc, gp, partial),
                _fold(cnt, gp, seg_sum(ctx, ok.to(torch.int64)), 0))

    def finalize(self, state, num_groups) -> Array:
        acc, cnt = state
        return Array(dt.bool_, acc, cnt > 0, length=num_groups)


class GroupedAny(_GroupedBoolean):
    """hash_any (``hash_aggregate.cc:1224``)."""
    name = "any"
    is_any = True


class GroupedAll(_GroupedBoolean):
    """hash_all (``hash_aggregate.cc:1300``)."""
    name = "all"
    is_any = False


# ---- mean-centred moments: variance, stddev, skew, kurtosis -----------------

def _partial_moments(x: torch.Tensor, ok: torch.Tensor, sums, spread,
                     nmom: int):
    """(mean, M2[, M3, M4], count) of the rows of each slot: ``sums`` maps
    a row stream to per-slot sums, ``spread`` maps per-slot values back to
    the rows. The slot means, refined once by the mean of the rows'
    deviations from them (a sum of values far from 0 loses digits that the
    deviations keep), then the powers of each row's deviation from its
    slot's mean."""
    cnt = sums(ok.to(torch.int64))
    n = cnt.clamp(min=1).to(torch.float64)
    mean = sums(torch.where(ok, x, 0.0)) / n
    d = torch.where(ok, x - spread(mean), 0.0)
    shift = sums(d) / n
    mean = mean + shift
    d = torch.where(ok, d - spread(shift), 0.0)
    moments, p = [], d
    for _ in range(nmom - 1):
        p = p * d
        moments.append(sums(p))
    return (mean, *moments, cnt)


def _shifted(moments, d, n):
    """Central moments (M2[, M3, M4]) of one partial about a point ``d``
    below its mean (the binomial shift; M1 about its own mean is 0)."""
    out = [moments[0] + n * d * d]
    if len(moments) > 1:
        m2, m3, m4 = moments
        out.append(m3 + 3 * d * m2 + n * d ** 3)
        out.append(m4 + 4 * d * m3 + 6 * d * d * m2 + n * d ** 4)
    return out


def _combine_moments(state, other, mapping: torch.Tensor):
    """Fold the partial moments ``other`` (mean, M2[, M3, M4], count) into
    ``state`` at ``mapping`` (mapping >= G dropped; several partials may
    share a target). The combined mean is the count-weighted mean; every
    partial's moments then shift to it exactly, so no raw power sum is
    ever formed."""
    mean_s, *ms, cnt_s = state
    mean_o, *mo, cnt_o = other
    G = cnt_s.shape[0]
    n_s = cnt_s.to(torch.float64)
    n_o = cnt_o.to(torch.float64)
    cnt = _fold(cnt_s, mapping, cnt_o, 0)
    total = _fold(n_s * mean_s, mapping, n_o * mean_o, 0.0)
    mean = torch.where(cnt > 0, total / cnt.clamp(min=1).to(torch.float64),
                       0.0)
    at = torch.clamp(mapping.long(), max=G)
    mean_at = torch.cat([mean, mean.new_zeros((1,))])[at]
    d_s = torch.where(cnt_s > 0, mean_s - mean, 0.0)
    d_o = torch.where(cnt_o > 0, mean_o - mean_at, 0.0)
    out = [_fold(a, mapping, b, 0.0)
           for a, b in zip(_shifted(ms, d_s, n_s), _shifted(mo, d_o, n_o))]
    return (mean, *out, cnt)


def _moments_from_power_sums(sums, cnt):
    """(mean, M2[, M3, M4]) from raw power sums s1..sk and the count (a
    JAX state)."""
    n = cnt.astype(np.float64)
    mean = sums[0] / np.maximum(n, 1.0)
    out = [mean, sums[1] - n * mean * mean]
    if len(sums) > 2:
        s1, s2, s3, s4 = sums
        out.append(s3 - 3 * mean * s2 + 2 * n * mean ** 3)
        out.append(s4 - 4 * mean * s3 + 6 * mean ** 2 * s2
                   - 3 * n * mean ** 4)
    return out


def _power_sums_from_moments(mean, moments, cnt):
    """Inverse of ``_moments_from_power_sums``."""
    n = cnt.astype(np.float64)
    out = [n * mean, moments[0] + n * mean * mean]
    if len(moments) > 1:
        m2, m3, m4 = moments
        out.append(m3 + 3 * mean * m2 + n * mean ** 3)
        out.append(m4 + 4 * mean * m3 + 6 * mean ** 2 * m2 + n * mean ** 4)
    return out


class _GroupedMoments(GroupedAggregator):
    """State (mean, M2[, M3, M4], count) per group, all float64 but the
    int64 count (``GroupedStatisticImpl``, ``hash_aggregate_numeric.cc:458``,
    keeps mean and M2 the same way)."""

    out_type = dt.float64
    nmom = 2

    def init(self, device=None):
        z = torch.zeros((self.G,), dtype=torch.float64, device=device)
        return tuple(z.clone() for _ in range(self.nmom)) + (
            torch.zeros((self.G,), dtype=torch.int64, device=device),)

    def consume(self, state, values, group_ids):
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G).long()
        G = self.G

        def sums(x):
            return x.new_zeros((G + 1,)).index_add_(0, pos, x)[:G]

        def spread(per_slot):
            return torch.cat([per_slot, per_slot.new_zeros((1,))])[pos]

        part = _partial_moments(values.values.to(torch.float64), ok, sums,
                                spread, self.nmom)
        return _combine_moments(state, part, torch.arange(
            G, device=pos.device))

    def consume_grouped(self, state, values, ctx):
        v_sorted, ok = _sorted_inputs(values, ctx)

        def spread(per_run):
            return torch.cat([per_run, per_run.new_zeros((1,))])[ctx.slot]

        part = _partial_moments(v_sorted.to(torch.float64), ok,
                                lambda x: seg_sum(ctx, x), spread,
                                self.nmom)
        return _combine_moments(state, part, _gpos(ctx, self.G))

    def merge(self, state, other, mapping):
        return _combine_moments(state, other, mapping)

    def state_from_numpy(self, st, tensor):
        *sums, cnt = (np.asarray(x) for x in st)
        return tuple(tensor(x) for x in
                     _moments_from_power_sums(sums, cnt)) + (tensor(cnt),)

    def state_to_numpy(self, st) -> list:
        mean, *moments, cnt = (x.cpu().numpy() for x in st)
        return _power_sums_from_moments(mean, moments, cnt) + [cnt]


class GroupedVariance(_GroupedMoments):
    """hash_variance / hash_stddev (``GroupedStatisticImpl``,
    ``hash_aggregate_numeric.cc:458``): M2 / (count - ddof), null where
    count - ddof <= 0."""

    name = "variance"
    is_std = False

    def finalize(self, state, num_groups) -> Array:
        _, m2, cnt = state
        ddof = self.options.ddof if isinstance(
            self.options, VarianceOptions) else 0
        denom = cnt.to(torch.float64) - ddof
        validity = denom > 0
        var = torch.clamp(m2 / torch.where(validity, denom, 1.0), min=0.0)
        return Array(dt.float64, torch.sqrt(var) if self.is_std else var,
                     validity, length=num_groups)


class GroupedStddev(GroupedVariance):
    name = "stddev"
    is_std = True


class _GroupedHigherMoments(_GroupedMoments):
    """hash_skew / hash_kurtosis: the population (biased) statistics of
    the JAX package, from M2, M3, M4; NaN where the group's values are all
    equal, null where it has none."""

    nmom = 4

    def _central(self, state):
        _, m2, m3, m4, cnt = state
        n = cnt.to(torch.float64).clamp(min=1.0)
        return m2 / n, m3 / n, m4 / n


class GroupedSkew(_GroupedHigherMoments):
    name = "skew"

    def finalize(self, state, num_groups) -> Array:
        m2, m3, _ = self._central(state)
        r = torch.where(m2 > 0, m3 / torch.sqrt(m2.clamp(min=1e-300)) ** 3,
                        float("nan"))
        return Array(dt.float64, r, state[-1] > 0, length=num_groups)


class GroupedKurtosis(_GroupedHigherMoments):
    name = "kurtosis"

    def finalize(self, state, num_groups) -> Array:
        m2, _, m4 = self._central(state)
        r = torch.where(m2 > 0, m4 / (m2 * m2).clamp(min=1e-300) - 3.0,
                        float("nan"))
        return Array(dt.float64, r, state[-1] > 0, length=num_groups)


# ---- first / last / one ----------------------------------------------------

_ROW_MAX = (1 << 63) - 1


class GroupedFirst(GroupedAggregator):
    """hash_first / hash_last (``hash_aggregate.cc:730``): the value at the
    smallest / largest row position of each group's valid values.

    State: (best row (G,) int64, value (G,), base): ``base`` counts the rows
    consumed before (a 0-d int64), so that several consumes order
    correctly. The row positions are local to one state: across the
    shards of ``DistGroupBy`` the first of a group is its first on one
    shard."""

    name = "first"
    is_first = True

    @property
    def out_type(self):
        return self.in_type

    @property
    def _sentinel(self) -> int:
        return _ROW_MAX if self.is_first else -1

    @property
    def _reduce(self) -> str:
        return "amin" if self.is_first else "amax"

    def _dtype(self) -> torch.dtype:
        d = torch_dtype(self.in_type)
        return torch.uint8 if d == torch.bool else d

    def init(self, device=None):
        return (torch.full((self.G,), self._sentinel, dtype=torch.int64,
                           device=device),
                torch.zeros((self.G,), dtype=self._dtype(), device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def _put(self, val, at, v):
        """val with v written at ``at`` (>= G dropped); wide unsigned
        values move as their signed bits."""
        G = self.G
        buf = torch.cat([as_signed_bits(val), as_signed_bits(val[:1])])
        return buf.index_copy_(0, torch.clamp(at.long(), max=G),
                               as_signed_bits(v.to(val.dtype)))[:G] \
            .view(val.dtype)

    def _winners(self, best, gids, cand, ok):
        """Rows whose candidate is their group's best."""
        G = self.G
        at = torch.where(ok & (gids >= 0) & (gids < G), gids, G).long()
        ext = torch.cat([best, best.new_full((1,), -2)])
        return ok & (ext[at] == cand)

    def consume(self, state, values, group_ids):
        best, val, base = state
        cap = values.capacity
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        rows = base + torch.arange(cap, dtype=torch.int64,
                                   device=best.device)
        cand = torch.where(ok, rows, self._sentinel)
        best2 = _fold(best, pos, cand, self._sentinel, self._reduce)
        win = self._winners(best2, group_ids, rows, ok)
        val2 = self._put(val, torch.where(win, group_ids, self.G),
                         values.values)
        return best2, val2, base + cap

    def consume_grouped(self, state, values, ctx):
        best, val, base = state
        cap = values.capacity
        _, ok = _sorted_inputs(values, ctx)
        if self.is_first:
            rowid = seg_first_row(ctx, ok)
            has = rowid < cap
        else:
            rowid = seg_last_row(ctx, ok)
            has = rowid >= 0
        has = has & (ctx.gid_global >= 0)
        cand = torch.where(has, base + rowid, self._sentinel)
        gp = torch.where(has, ctx.gid_global, self.G)
        best2 = _fold(best, gp, cand, self._sentinel, self._reduce)
        take = self._winners(best2, ctx.gid_global, cand, has)
        rc = rowid.clamp(0, max(cap - 1, 0)).long()
        val2 = self._put(val, torch.where(take, ctx.gid_global, self.G),
                         gather_rows(values.values, rc))
        return best2, val2, base + cap

    def merge(self, state, other, mapping):
        best, val, base = state
        obest, oval, obase = other
        newbest = _fold(best, mapping, obest, self._sentinel, self._reduce)
        takes = self._winners(newbest, mapping, obest,
                              obest != self._sentinel)
        val = self._put(val, torch.where(takes, mapping, self.G), oval)
        return newbest, val, torch.maximum(base, obase.reshape(()))

    def state_from_numpy(self, st, tensor):
        best, val, base = st
        return (tensor(best), tensor(self.acc_from_numpy(np.asarray(val))),
                tensor(np.asarray(base).reshape(())))

    def state_to_numpy(self, st) -> list:
        best, val, base = (x.cpu().numpy() for x in st)
        return [best, val, np.atleast_1d(base)]

    def finalize(self, state, num_groups) -> Array:
        best, val, _ = state
        out = val.to(torch.bool) if torch_dtype(self.in_type) == torch.bool \
            else val
        return Array(self.in_type, out, best != self._sentinel,
                     length=num_groups)


class GroupedLast(GroupedFirst):
    name = "last"
    is_first = False


class GroupedOne(GroupedLast):
    """hash_one (``hash_aggregate.cc:1550``): any value of the group (the
    last, as in the JAX package)."""
    name = "one"


# ---- count_distinct -----------------------------------------------------------

class GroupedCountDistinct(GroupedAggregator):
    """hash_count_distinct (``hash_aggregate.cc:1394``): a second Grouper
    over (group id, value) pairs remembers which values each group has
    seen, so the distinct count per group is one scan of the pair table
    at finalize; ``merge`` replays the other table's pairs with their
    group ids mapped.

    The pair table holds ``max_pairs`` pairs (the options' ``max_pairs``
    attribute, default max(4 G, 4096), read as the JAX package reads it).
    Past it the pair grouper's error is set, and ``error_flag`` reports
    it (the JAX package drops the pairs silently: ROADMAP C26)."""

    dist_rows = False

    name = "count_distinct"
    out_type = dt.int64

    def __init__(self, in_type, G, options=None):
        super().__init__(in_type, G, options)
        from .grouper import Grouper
        self.mode = _count_mode(options)
        self.max_pairs = getattr(options, "max_pairs", None) or max(
            4 * G, 1 << 12)
        self.pair_grouper = Grouper([dt.int32, in_type],
                                    [False, self.mode == "all"],
                                    max_groups=self.max_pairs)

    def init(self, device=None):
        return self.pair_grouper.init_state(device)

    def consume(self, state, values, group_ids):
        cap = values.capacity
        active = group_ids >= 0
        if self.mode == "only_valid" and values.validity is not None:
            active = active & values.validity
        gid_col = Array(dt.int32, group_ids.to(torch.int32), None,
                        length=cap)
        val_col = values if self.mode == "all" else values.with_validity(None)
        new_state, _ = self.pair_grouper.consume(
            state, [gid_col, val_col], length=cap, active=active)
        return new_state

    def merge(self, state, other, mapping):
        occupied = other.table_gid >= 0
        gid = other.table_lanes[:, 0]
        new_gid = mapping.long()[gid.clamp(0, mapping.shape[0] - 1)]
        lanes = other.table_lanes.clone()
        lanes[:, 0] = new_gid & U32
        new_state, _ = self.pair_grouper._consume_lanes(state, lanes,
                                                        occupied)
        return new_state

    def state_from_numpy(self, st, tensor):
        from .grouper import GrouperState
        return GrouperState(tensor(np.asarray(st.table_lanes)
                                   .astype(np.int64)),
                            tensor(st.table_gid), tensor(st.num_groups),
                            tensor(st.error))

    def error_flag(self, state) -> torch.Tensor:
        return state.error

    def error_message(self, flag: int) -> str:
        return (f"count_distinct: more than {self.max_pairs} distinct "
                "(group, value) pairs; raise max_pairs (an attribute of "
                "the CountOptions)")

    def finalize(self, state, num_groups) -> Array:
        occupied = state.table_gid >= 0
        gid = state.table_lanes[:, 0]
        counts = _fold(torch.zeros((self.G,), dtype=torch.int64,
                                   device=gid.device),
                       torch.where(occupied, gid, self.G),
                       occupied.to(torch.int64), 0)
        return Array(dt.int64, counts, None, length=num_groups)


# ---- tdigest / approximate_median ---------------------------------------------

class GroupedTDigest(GroupedAggregator):
    """hash_tdigest / hash_approximate_median (``hash_aggregate_numeric.cc``
    GroupedTDigestImpl :903), as the JAX package computes them: (group id,
    value) pairs are buffered and each group's quantiles are EXACT at
    finalize (one sort by group then value, a binary search per group and
    linear interpolation): a t-digest with delta -> inf.

    ``buffer_rows`` (an attribute of the options, default 2^16, read as
    the JAX package reads it) must cover the rows consumed: each consume
    appends the batch's whole capacity, inactive rows as group -1, as the
    JAX package does. Past it the state's error is set and ``error_flag``
    reports it (the JAX package computes from an overwritten buffer and
    reports nothing: ROADMAP C25). The buffers are updated in place (an
    append, not a copy of buffers that may hold 10^8 rows). One float64
    column out for one q, an (n, len(q)) matrix for several."""

    dist_rows = False

    name = "tdigest"
    out_type = dt.float64
    default_rows = 1 << 16

    def __init__(self, in_type, G, options=None):
        super().__init__(in_type, G, options)
        qs = getattr(options, "q", None) or [0.5]
        self.qs = [qs] if np.isscalar(qs) else list(qs)
        self.rows = getattr(options, "buffer_rows", None) or \
            self.default_rows

    def init(self, device=None):
        return (torch.full((self.rows,), -1, dtype=torch.int32,
                           device=device),
                torch.zeros((self.rows,), dtype=torch.float64,
                            device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def _append(self, state, gids, vals):
        bg, bv, cnt, err = state
        n = gids.shape[0]
        if n > self.rows:       # can never fit: no write at all
            return bg, bv, cnt + n, err | 1
        err = err | (cnt + n > self.rows).to(torch.int32)
        at = torch.clamp(cnt, max=self.rows - n) + torch.arange(
            n, device=bg.device)
        bg.index_copy_(0, at, gids.to(torch.int32))
        bv.index_copy_(0, at, vals.to(torch.float64))
        return bg, bv, cnt + n, err

    def consume(self, state, values, group_ids):
        ok = _contrib_mask(values, group_ids)
        return self._append(state, torch.where(ok, group_ids, -1),
                            torch.where(ok, values.values.to(torch.float64),
                                        0.0))

    def consume_grouped(self, state, values, ctx):
        v_sorted, ok = _sorted_inputs(values, ctx)
        R = ctx.starts.shape[0]
        gid_run = torch.cat([ctx.gid_global, ctx.gid_global.new_full(
            (1,), -1)])
        gids = gid_run[torch.where(ok, ctx.slot, R)]
        return self._append(state, gids, torch.where(
            ok, v_sorted.to(torch.float64), 0.0))

    def merge(self, state, other, mapping):
        """Append the other buffer's used rows (one host read of its
        count) with their groups mapped. The JAX package appends the other
        buffer whole, so that a merge into a state that holds any row
        needs twice the buffer."""
        og, ov, ocnt, oerr = other
        used = min(int(ocnt), og.shape[0])
        og, ov = og[:used], ov[:used]
        m = torch.cat([mapping.to(torch.int32),
                       mapping.new_full((1,), -1).to(torch.int32)])
        remap = m[torch.where(og >= 0, og.long().clamp(
            max=mapping.shape[0] - 1), mapping.shape[0])]
        remap = torch.where(remap >= self.G, -1, remap)
        bg, bv, cnt, err = self._append(state, remap, ov)
        return bg, bv, cnt, err | oerr

    def state_from_numpy(self, st, tensor):
        bg, bv, cnt, err = st
        return (tensor(bg), tensor(bv),
                tensor(np.asarray(cnt).astype(np.int64).reshape(())),
                tensor(np.asarray(err).reshape(())))

    def error_flag(self, state) -> torch.Tensor:
        return state[3]

    def error_message(self, flag: int) -> str:
        return (f"{self.name}: more than {self.rows} rows buffered; raise "
                "buffer_rows (an attribute of the options) to cover the "
                "rows consumed")

    def finalize(self, state, num_groups) -> Array:
        bg, bv, _, _ = state
        active = bg >= 0
        skey = torch.where(active, bv, float("inf"))
        gkey = torch.where(active, bg, torch.iinfo(torch.int32).max)
        order = torch.sort(skey).indices
        order = order[torch.sort(gkey[order], stable=True).indices]
        sg = gkey[order].contiguous()
        sv = bv[order]
        gidx = torch.arange(self.G, dtype=torch.int32, device=bg.device)
        starts = torch.searchsorted(sg, gidx)
        n = (torch.searchsorted(sg, gidx, right=True) - starts) \
            .to(torch.float64)
        outs = []
        for q in self.qs:
            rank = q * (n - 1.0).clamp(min=0.0)
            lo = (starts + torch.floor(rank).long()).clamp(0, self.rows - 1)
            hi = (starts + torch.ceil(rank).long()).clamp(0, self.rows - 1)
            frac = rank - torch.floor(rank)
            outs.append(sv[lo] + frac * (sv[hi] - sv[lo]))
        out = outs[0] if len(outs) == 1 else torch.stack(outs, dim=1)
        return Array(dt.float64, out, n > 0, length=num_groups)


class GroupedApproximateMedian(GroupedTDigest):
    name = "approximate_median"

    def __init__(self, in_type, G, options=None):
        super().__init__(in_type, G, options)
        self.qs = [0.5]


# ---- decimal sum ----------------------------------------------------------------

class GroupedDecimalSum(GroupedAggregator):
    """hash_sum over decimal columns with EXACT 128-bit accumulation
    (``util/decimal.h:410`` int128 semantics; output decimal(38|76, s)):
    each value splits into three int64 partials (the hi limb, the high and
    low 32 bits of the lo limb), each summed exactly (n < 2^31 rows), and
    finalize recombines them with explicit carries into the two-limb
    (G, 2) storage. Narrow ((cap,) scaled int64) and wide ((cap, 2) limb)
    inputs alike. Sums past +-2^127 scaled units wrap, as the reference's
    release-mode decimal sum does."""

    name = "decimal_sum"

    @property
    def out_type(self):
        t = self.in_type
        return dt.DecimalType(38 if t.bits == 128 else 76, t.scale, t.bits)

    def init(self, device=None):
        return tuple(torch.zeros((self.G,), dtype=torch.int64, device=device)
                     for _ in range(4))

    @staticmethod
    def _parts(v: torch.Tensor, ok: torch.Tensor):
        if v.ndim == 2:
            lo, hi = v[:, 0], v[:, 1]
        else:
            lo, hi = v, v >> 63
        return (torch.where(ok, hi, 0), torch.where(ok, (lo >> 32) & U32, 0),
                torch.where(ok, lo & U32, 0))

    def consume(self, state, values, group_ids):
        ok = _contrib_mask(values, group_ids)
        pos = _positions(ok, group_ids, self.G)
        parts = self._parts(values.values, ok) + (ok.to(torch.int64),)
        return tuple(_fold(a, pos, p, 0) for a, p in zip(state, parts))

    def consume_grouped(self, state, values, ctx):
        v_sorted, ok = _sorted_inputs(values, ctx)
        parts = self._parts(v_sorted, ok) + (ok.to(torch.int64),)
        gp = _gpos(ctx, self.G)
        return tuple(_fold(a, gp, seg_sum(ctx, p), 0)
                     for a, p in zip(state, parts))

    def merge(self, state, other, mapping):
        return tuple(_fold(a, mapping, o, 0) for a, o in zip(state, other))

    def finalize(self, state, num_groups) -> Array:
        hi_a, lohi_a, lolo_a, cnt = state
        # total = hi * 2^64 + lohi * 2^32 + lolo (mod 2^128); lolo and lohi
        # are exact nonnegative sums, hi a signed one; int64 adds wrap
        b_low = (lohi_a & U32) << 32
        low64 = lolo_a + b_low
        carry = ((lolo_a >> 32) + (lohi_a & U32)) >> 32
        hi64 = hi_a + (lohi_a >> 32) + carry
        return Array(self.out_type, torch.stack([low64, hi64], dim=1),
                     cnt > 0, length=num_groups)


GROUPED_AGGREGATORS = {
    a.name: a for a in (
        GroupedCount, GroupedCountAll, GroupedSum, GroupedProduct,
        GroupedMean, GroupedMin, GroupedMax, GroupedAny, GroupedAll,
        GroupedVariance, GroupedStddev, GroupedFirst, GroupedLast,
        GroupedOne, GroupedCountDistinct, GroupedSkew, GroupedKurtosis,
        GroupedTDigest, GroupedApproximateMedian)
}


def make_grouped_aggregator(name: str, in_type: Optional[dt.DataType],
                            max_groups: int, options=None
                            ) -> GroupedAggregator:
    key = name[5:] if name.startswith("hash_") else name
    if isinstance(in_type, dt.DecimalType):
        if key == "sum":
            return GroupedDecimalSum(in_type, max_groups, options)
        if key in ("mean", "product", "tdigest", "approximate_median",
                   "variance", "stddev", "skew", "kurtosis") and \
                in_type.wide:
            raise NotImplementedError(
                f"{key} over wide (precision>18) decimals: cast to a "
                "narrower decimal or float first")
    if key in ("min", "max", "first", "last", "one", "list") and \
            in_type is not None and (in_type.is_varlen or isinstance(
                in_type, dt.DictionaryType) or
                (isinstance(in_type, dt.DecimalType) and in_type.wide)):
        raise NotImplementedError(
            f"hash_{key} of {in_type}: not ported (ROADMAP C37)")
    if key not in GROUPED_AGGREGATORS:
        # list and pivot_wider live in kernel modules loaded on demand
        from ..compute.registry import ensure_kernels_loaded
        ensure_kernels_loaded()
    if key not in GROUPED_AGGREGATORS:
        raise KeyError(f"no grouped aggregator named {name!r}")
    return GROUPED_AGGREGATORS[key](in_type, max_groups, options)


# ---- scalar (whole-array) aggregates ----------------------------------------

def _scalar_reduce(name: str, a: Array, options) -> Scalar:
    """One aggregate over the live rows of ``a``, read on the host as a
    Scalar (the JAX package's ``_scalar_reduce``): null unless at least
    ``min_count`` values are valid, and with ``skip_nulls=False`` null
    where any live row is."""
    opts = options if isinstance(
        options, (ScalarAggregateOptions, VarianceOptions)) else None
    skip_nulls = True if opts is None else opts.skip_nulls
    min_count = 1 if opts is None else opts.min_count
    live = a.row_mask()
    present = a.present_mask()
    v = a.values

    def done(value, out_type, valid=True):
        pyv = value.item() if isinstance(value, torch.Tensor) else value
        return Scalar(out_type.storage_np.type(pyv) if valid else None,
                      out_type, is_valid=bool(valid))

    if name == "count":
        mode = _count_mode(options)
        if mode == "only_valid":
            return done(present.sum(), dt.int64)
        if mode == "only_null":
            return done((live & ~a.validity).sum()
                        if a.validity is not None else 0, dt.int64)
        return done(live.sum(), dt.int64)
    n_valid = int(present.sum())
    ok = n_valid >= max(min_count, 1)
    if not skip_nulls and a.validity is not None and \
            bool((live & ~a.validity).any()):
        ok = False
    if name in ("sum", "mean", "product"):
        t = dt.float64 if name == "mean" else _sum_output_type(a.type)
        if v.dtype in SIGNED_OF:
            v = unsigned_to_int64(v)
        acc_dtype = torch.int64 if torch_dtype(t) == torch.uint64 \
            else torch_dtype(t)
        if name == "product":
            total = torch.where(present, v.to(acc_dtype), 1).prod(
                dtype=acc_dtype)
        else:
            total = torch.where(present, v.to(acc_dtype), 0).sum(
                dtype=acc_dtype)
        if name == "mean":
            return done(total / max(n_valid, 1), t, ok)
        if torch_dtype(t) == torch.uint64:
            total = total.view(torch.uint64)
        return done(total, t, ok)
    if name in ("min", "max"):
        d = torch_dtype(a.type)
        if d in FLOAT_KEY:
            return done(_float_extremum(v, present, name == "min"), a.type,
                        ok)
        if d in SIGNED_OF:
            v = ordered_signed(v)
        elif d == torch.bool:
            v = v.to(torch.uint8)
        ident = extreme_identity(v.dtype, name == "min")
        acc = torch.where(present, v, ident)
        r = acc.min() if name == "min" else acc.max()
        if d in SIGNED_OF:
            r = from_ordered_signed(r, d)
        return done(r.to(torch.bool) if d == torch.bool else r, a.type, ok)
    if name == "any":
        return done(torch.where(present, v.to(torch.bool), False).any(),
                    dt.bool_, ok)
    if name == "all":
        return done(torch.where(present, v.to(torch.bool), True).all(),
                    dt.bool_, ok)
    if name in ("variance", "stddev"):
        ddof = options.ddof if isinstance(options, VarianceOptions) else 0
        x = v.to(torch.float64)
        mean = torch.where(present, x, 0.0).sum() / max(n_valid, 1)
        centred = torch.where(present, x - mean, 0.0)
        var = (centred * centred).sum() / max(n_valid - ddof, 1)
        valid = n_valid > 0 and n_valid - ddof > 0 and ok
        return done(torch.sqrt(var) if name == "stddev" else var,
                    dt.float64, valid)
    raise KeyError(name)


def _float_extremum(v: torch.Tensor, present: torch.Tensor,
                    is_min: bool) -> torch.Tensor:
    """The min (max) of the present values of a float column, NaN skipped
    as pyarrow skips it: NaN only when every present value is NaN."""
    k = torch.where(present, float_extreme_key(v, is_min),
                    extreme_identity(FLOAT_KEY[v.dtype], is_min))
    return float_from_extreme_key(k.min() if is_min else k.max(), is_min,
                                  v.dtype)


def _register_scalar_aggs():
    for name in ("sum", "product", "mean", "min", "max", "any", "all",
                 "variance", "stddev", "count"):
        opts_cls = {"count": CountOptions, "variance": VarianceOptions,
                    "stddev": VarianceOptions}.get(name,
                                                   ScalarAggregateOptions)

        def _exec(args, options, _name=name):
            (a,) = args
            return _scalar_reduce(_name, a, options)

        register_function(name, Kind.SCALAR_AGGREGATE, 1,
                          null_handling=NullHandling.COMPUTED,
                          options_class=opts_cls)(_exec)


_register_scalar_aggs()


@register_function("count_all", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED)
def _count_all(args, options):
    """Row count including nulls (aggregate_basic.cc CountAll)."""
    (a,) = args
    return Scalar(len(a), dt.int64)


def _register_hash_aggs():
    """Register the hash_* names, as the reference's ``initialize.cc``
    registers the grouped kernels as functions: a direct call raises, for
    they run only through grouped contexts (the aggregate node,
    ``Table.group_by``)."""
    for key in list(GROUPED_AGGREGATORS) + ["count_all", "min_max",
                                            "first_last", "distinct",
                                            "any", "all", "list",
                                            "pivot_wider"]:
        name = f"hash_{key}"

        def _exec(args, options, _n=name):
            raise ValueError(
                f"Direct calls to \"{_n}\" are not valid: hash "
                f"aggregates execute through group_by/aggregate nodes")
        if name not in registry._functions:
            register_function(name, Kind.HASH_AGGREGATE, -1,
                              null_handling=NullHandling.COMPUTED)(_exec)


_register_hash_aggs()
