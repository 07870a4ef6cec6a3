"""Order-statistic and other scalar aggregates: min_max / first / last /
first_last / index / count_distinct / quantile / tdigest /
approximate_median / mode / skew / kurtosis, and winsorize; the
counterpart of the JAX package's ``ops/aggregates_order.py``.

Reference: ``aggregate_basic.cc`` (min_max / first / last / index),
``aggregate_mode.cc``, ``aggregate_quantile.cc`` (exact quantile, five
interpolations), ``aggregate_tdigest.cc``, ``aggregate_var_std.cc`` and
``vector_statistics.cc`` (skew / kurtosis / winsorize).

As in the JAX package: quantiles sort once and interpolate (exact);
tdigest / approximate_median compute the exact quantiles too (a t-digest
with delta -> inf); mode is value_counts plus one ordering by (count
descending, value ascending); skew and kurtosis centre the values on their
mean before taking powers (``_central_moments``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch
from ..core.schema import Field, Schema
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from .agg_options import CountOptions, ScalarAggregateOptions
from .aggregates import _float_extremum
from .bits import FLOAT_KEY, SIGNED_OF, from_ordered_signed, ordered_signed
from .kernel_utils import torch_dtype
from .segment import extreme_identity

__all__ = ["ModeOptions", "QuantileOptions", "TDigestOptions",
           "IndexOptions", "SkewOptions", "WinsorizeOptions"]


class ModeOptions:
    def __init__(self, n: int = 1, skip_nulls: bool = True,
                 min_count: int = 0):
        self.n = n
        self.skip_nulls = skip_nulls
        self.min_count = min_count


class QuantileOptions:
    def __init__(self, q=0.5, interpolation: str = "linear",
                 skip_nulls: bool = True, min_count: int = 0):
        self.q = [q] if np.isscalar(q) else list(q)
        assert interpolation in ("linear", "lower", "higher", "nearest",
                                 "midpoint")
        self.interpolation = interpolation
        self.skip_nulls = skip_nulls
        self.min_count = min_count


class TDigestOptions:
    """``buffer_rows``: the grouped tdigest's buffer (rows it may consume;
    ``aggregates.GroupedTDigest``). The JAX package reads the same
    attribute but sets it only by assignment."""

    def __init__(self, q=0.5, delta: int = 100, buffer_size: int = 500,
                 skip_nulls: bool = True, min_count: int = 0,
                 buffer_rows=None):
        self.q = [q] if np.isscalar(q) else list(q)
        self.delta = delta
        self.buffer_size = buffer_size
        self.skip_nulls = skip_nulls
        self.min_count = min_count
        self.buffer_rows = buffer_rows


class IndexOptions:
    def __init__(self, value=None):
        self.value = value


class SkewOptions:
    def __init__(self, skip_nulls: bool = True, biased: bool = True,
                 min_count: int = 0):
        self.skip_nulls = skip_nulls
        self.biased = biased
        self.min_count = min_count


class WinsorizeOptions:
    def __init__(self, lower_limit: float = 0.0, upper_limit: float = 1.0):
        self.lower_limit = lower_limit
        self.upper_limit = upper_limit


def _agg_guard(a: Array, options) -> tuple:
    """(valid count, and whether the options let a result be valid): at
    least max(min_count, 1) valid values, and no null with
    ``skip_nulls=False``. One host read each."""
    present = a.present_mask()
    n_valid = int(present.sum())
    skip = getattr(options, "skip_nulls", True) if options is not None \
        else True
    has_null = False
    if not skip and a.validity is not None:
        has_null = bool((a.row_mask() & ~a.validity).any())
    min_count = getattr(options, "min_count", 0) if options else 0
    return n_valid, (n_valid >= max(min_count, 1)) and not has_null


def _py(v: torch.Tensor, t: dt.DataType):
    if t.is_varlen:             # v: a row of the column
        return v
    out = v.item()
    if isinstance(t, dt.BoolType):
        return bool(out)
    return t.storage_np.type(out).item() if t.is_primitive else out


def _orderable(v: torch.Tensor):
    """(values torch can order on the card, how to turn one back): bool as
    uint8, wide unsigned as their ordered signed values."""
    if v.dtype in SIGNED_OF:
        return ordered_signed(v), lambda r: from_ordered_signed(r, v.dtype)
    if v.dtype == torch.bool:
        return v.to(torch.uint8), lambda r: r.to(torch.bool)
    return v, lambda r: r


# ---- min_max / first / last / first_last -------------------------------------

def _row_value(a: Array, row) -> object:
    """Row ``row`` of a string (str) or binary (bytes) column: one host
    read of its bytes."""
    lo, hi = (int(x) for x in a.offsets[row:row + 2].cpu())
    raw = a.values[lo:hi].cpu().numpy().tobytes()
    return raw.decode("utf-8") if isinstance(a.type, dt.StringType) else raw


def _check_orderable(a: Array, fn: str) -> None:
    """A dictionary or nested column raises naming its type: these
    functions are defined on it and not ported."""
    t = a.type
    if isinstance(t, dt.DictionaryType) or t.is_nested:
        raise NotImplementedError(f"{fn} of {t}")


def _varlen_extremum(a: Array, which: str):
    """The least (greatest) present string or binary value: a sort whose
    prefix covers the longest row (one host read), read at the first
    (last) present position."""
    from .sorting import sort_indices_array
    present = a.present_mask()
    lens = torch.where(present, a.offsets[1:] - a.offsets[:-1], 0)
    words = max(1, -(-int(lens.max()) // 4))
    perm = sort_indices_array(a, varlen_words=words).values.view(torch.int64)
    pos = 0 if which == "min" else int(present.sum()) - 1
    return _row_value(a, perm[pos])


def _extremum(a: Array, which: str):
    if a.type.is_varlen:
        return _varlen_extremum(a, which)
    v, back = _orderable(a.values)
    present = a.present_mask()
    if v.dtype in FLOAT_KEY:        # NaN skipped, as pyarrow skips it
        return _float_extremum(v, present, which == "min")
    ident = extreme_identity(v.dtype, which == "min")
    acc = torch.where(present, v, ident)
    return back(acc.min() if which == "min" else acc.max())


@register_function("min_max", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ScalarAggregateOptions)
def _min_max(args, options):
    (a,) = args
    _check_orderable(a, "min_max")
    _, ok = _agg_guard(a, options)
    t = a.type
    st = dt.struct([("min", t), ("max", t)])
    if not ok:
        return Scalar({"min": None, "max": None}, st, is_valid=True)
    return Scalar({"min": _py(_extremum(a, "min"), t),
                   "max": _py(_extremum(a, "max"), t)}, st)


def _edge_value(a: Array, first: bool):
    """(value at the first / last valid position, any valid)."""
    present = a.present_mask()
    cap = a.capacity
    idx = torch.arange(cap, device=a.device)
    if first:
        pos = torch.where(present, idx, cap).min().clamp(max=cap - 1)
    else:
        pos = torch.where(present, idx, -1).max().clamp(min=0)
    if a.type.is_varlen:
        return _row_value(a, pos), bool(present.any())
    return a.values[pos], bool(present.any())


def _first_last_exec(which):
    def _fn(args, options):
        (a,) = args
        _check_orderable(a, which)
        _, ok = _agg_guard(a, options)
        t = a.type
        if which in ("first", "last"):
            v, any_ok = _edge_value(a, which == "first")
            valid = ok and any_ok
            return Scalar(_py(v, t) if valid else None, t, is_valid=valid)
        st = dt.struct([("first", t), ("last", t)])
        if not ok:
            return Scalar({"first": None, "last": None}, st, is_valid=True)
        fv, any_ok = _edge_value(a, True)
        lv, _ = _edge_value(a, False)
        if not any_ok:
            return Scalar({"first": None, "last": None}, st, is_valid=True)
        return Scalar({"first": _py(fv, t), "last": _py(lv, t)}, st)
    return _fn


for _name in ("first", "last", "first_last"):
    register_function(_name, Kind.SCALAR_AGGREGATE, 1,
                      null_handling=NullHandling.COMPUTED,
                      options_class=ScalarAggregateOptions)(
        _first_last_exec(_name))


@register_function("index", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=IndexOptions)
def _index(args, options):
    (a,) = args
    if options is None or options.value is None:
        raise ValueError("index requires IndexOptions(value=...)")
    cap = a.capacity
    target = torch.as_tensor(options.value).to(a.values.dtype)
    hit = a.present_mask() & (a.values == target.to(a.device))
    pos = int(torch.where(hit, torch.arange(cap, device=a.device),
                          cap).min()) if cap else cap
    return Scalar(-1 if pos == cap else pos, dt.int64)


@register_function("count_distinct", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=CountOptions)
def _count_distinct(args, options):
    from .vector_hash import _distinct
    (a,) = args
    mode = options.mode if isinstance(options, CountOptions) else "only_valid"
    if mode == "only_null":
        raise NotImplementedError("count_distinct mode=only_null")
    _, _, n = _distinct(a, include_nulls=mode == "all")
    return Scalar(int(n), dt.int64)


# ---- quantile family ----------------------------------------------------------

def _sorted_valid(a: Array):
    """(values sorted ascending, nulls and padding last as +inf; the valid
    count): floats in their own type, integers as float64."""
    present = a.present_mask()
    v = a.values
    d = v.dtype if v.dtype.is_floating_point else torch.float64
    s = torch.sort(torch.where(present, v.to(d), float("inf"))).values
    return s, present.sum()


def _quantile_values(a: Array, qs: Sequence[float],
                     interpolation: str) -> torch.Tensor:
    """(len(qs),) float64 exact quantiles."""
    s, n = _sorted_valid(a)
    hi_idx = max(a.capacity - 1, 0)
    nf = n.to(torch.float64)
    out = []
    for q in qs:
        rank = q * (nf - 1.0)
        lo = torch.floor(rank).long().clamp(0, hi_idx)
        hi = torch.ceil(rank).long().clamp(0, hi_idx)
        vlo = s[lo].to(torch.float64)
        vhi = s[hi].to(torch.float64)
        if interpolation == "linear":
            out.append(vlo + (rank - torch.floor(rank)) * (vhi - vlo))
        elif interpolation == "lower":
            out.append(vlo)
        elif interpolation == "higher":
            out.append(vhi)
        elif interpolation == "midpoint":
            out.append((vlo + vhi) * 0.5)
        else:   # nearest: round half to even (std::nearbyint)
            out.append(s[torch.round(rank).long().clamp(0, hi_idx)]
                       .to(torch.float64))
    return torch.stack(out)


def _quantile_exec(args, options, name="quantile"):
    (a,) = args
    opts = options or QuantileOptions()
    qs = opts.q
    interp = getattr(opts, "interpolation", "linear")
    n_valid, ok = _agg_guard(a, opts)
    ok = ok and n_valid > 0
    vals = _quantile_values(a, qs, interp)
    # lower / higher / nearest keep the input type; linear / midpoint f64
    if interp in ("lower", "higher", "nearest") and name == "quantile":
        out_t = a.type
        vals = vals.to(torch_dtype(a.type))
    else:
        out_t = dt.float64
    validity = None if ok else torch.zeros((len(qs),), dtype=torch.bool,
                                           device=vals.device)
    return Array(out_t, vals, validity, length=len(qs))


register_function("quantile", Kind.SCALAR_AGGREGATE, 1,
                  null_handling=NullHandling.COMPUTED,
                  options_class=QuantileOptions)(_quantile_exec)


@register_function("tdigest", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=TDigestOptions)
def _tdigest(args, options):
    opts = options or TDigestOptions()
    qopts = QuantileOptions(q=opts.q, skip_nulls=opts.skip_nulls,
                            min_count=opts.min_count)
    return _quantile_exec(args, qopts, name="tdigest")


@register_function("approximate_median", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ScalarAggregateOptions)
def _approx_median(args, options):
    (a,) = args
    opts = options or ScalarAggregateOptions()
    n_valid, ok = _agg_guard(a, opts)
    ok = ok and n_valid > 0
    v = _quantile_values(a, [0.5], "linear")[0]
    return Scalar(float(v) if ok else None, dt.float64, is_valid=ok)


@register_function("mode", Kind.SCALAR_AGGREGATE, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ModeOptions)
def _mode(args, options):
    """The n most common values, ties by the smaller value first; a
    2-column Batch (mode, count) in place of Arrow's StructArray."""
    from .vector_hash import _distinct
    (a,) = args
    opts = options or ModeOptions()
    codes, unique_rows, nuniq = _distinct(a, include_nulls=False)
    cap = codes.shape[0]
    dev = codes.device
    counts = torch.zeros((cap + 1,), dtype=torch.int64, device=dev) \
        .index_add_(0, torch.where(codes >= 0, codes, cap).long(),
                    torch.ones_like(codes, dtype=torch.int64))[:cap]
    in_use = torch.arange(cap, device=dev) < nuniq
    rows = torch.where(unique_rows == (1 << 31) - 1, 0, unique_rows).long()
    vkey, _ = _orderable(a.values[rows])
    if vkey.is_floating_point():
        vkey = torch.where(torch.isnan(vkey), float("inf"), vkey)
    vkey = torch.where(in_use, vkey, extreme_identity(vkey.dtype, True))
    order = torch.argsort(vkey, stable=True)
    ckey = torch.where(in_use, -counts, 1)[order]
    order = order[torch.argsort(ckey, stable=True)]
    _, ok = _agg_guard(a, opts)
    n_out = min(opts.n, int(nuniq)) if ok else 0
    top = order[:max(opts.n, 1)]
    schema = Schema((Field("mode", a.type, False),
                     Field("count", dt.int64, False)))
    return Batch(schema, [Array(a.type, a.values[rows[top]], None,
                                length=n_out),
                          Array(dt.int64, counts[top], None, length=n_out)],
                 n_out)


# ---- skew / kurtosis ----------------------------------------------------------

def _central_moments(a: Array):
    """(n, m2, m3, m4): the central moments of the valid values about
    their mean, each value centred before its powers are taken."""
    present = a.present_mask()
    x = a.values.to(torch.float64)
    n = present.sum().to(torch.float64)
    mean = torch.where(present, x, 0.0).sum() / n.clamp(min=1.0)
    cx = torch.where(present, x - mean, 0.0)
    d = n.clamp(min=1.0)
    return n, (cx * cx).sum() / d, (cx ** 3).sum() / d, (cx ** 4).sum() / d


def _skew_exec(args, options, kurtosis=False):
    (a,) = args
    opts = options or SkewOptions()
    n_valid, ok = _agg_guard(a, opts)
    n, m2, m3, m4 = _central_moments(a)
    if kurtosis:
        r = torch.where(m2 > 0, m4 / (m2 * m2) - 3.0, float("nan"))
    else:
        r = torch.where(m2 > 0, m3 / torch.sqrt(m2) ** 3, float("nan"))
    biased = getattr(opts, "biased", True)
    if not biased:
        if kurtosis:
            r = ((n + 1) * r + 6) * (n - 1) / ((n - 2) * (n - 3)).clamp(
                min=1.0)
        else:
            r = r * torch.sqrt(n * (n - 1)) / (n - 2).clamp(min=1.0)
    valid = ok and n_valid >= (1 if biased else (3 if kurtosis else 2))
    return Scalar(float(r) if valid else None, dt.float64, is_valid=valid)


register_function("skew", Kind.SCALAR_AGGREGATE, 1,
                  null_handling=NullHandling.COMPUTED,
                  options_class=SkewOptions)(_skew_exec)
register_function(
    "kurtosis", Kind.SCALAR_AGGREGATE, 1,
    null_handling=NullHandling.COMPUTED, options_class=SkewOptions)(
    lambda args, options: _skew_exec(args, options, kurtosis=True))


@register_function("winsorize", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=WinsorizeOptions)
def _winsorize(args, options):
    """``vector_statistics.cc`` Winsorize: clamp to the nearest data values
    at the limit quantiles (interpolation "higher" below, "lower"
    above)."""
    (a,) = args
    opts = options or WinsorizeOptions()
    lo = _quantile_values(a, [opts.lower_limit], "higher")[0]
    hi = _quantile_values(a, [opts.upper_limit], "lower")[0]
    v = a.values
    out = torch.minimum(torch.maximum(v, lo.to(v.dtype)), hi.to(v.dtype))
    return Array(a.type, out, a.validity, length=a.length)
