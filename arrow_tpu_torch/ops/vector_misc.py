"""Cumulative / pairwise / replace / fill-null vector kernels; the
counterpart of the JAX package's ``ops/vector_misc.py``.

Reference: ``cpp/src/arrow/compute/kernels/vector_cumulative_ops.cc``
(cumulative_sum/prod/min/max/mean with poison-on-null vs skip semantics),
``vector_pairwise.cc`` (pairwise_diff), ``vector_replace.cc``
(replace_with_mask, fill_null_forward/backward).

Scans and gathers, as in the JAX package: ``torch.cumsum`` / ``cumprod``
in the column's own dtype (integers wrap as Arrow's unchecked kernels do;
uint16 / uint32 / uint64 as the signed type of their width, which gives
the same bits), ``torch.cummin`` / ``cummax`` (uint16 / 32 / 64 through
their order-preserving signed form, ``bits.ordered_signed``), the "first
null poisons the rest" mask as a running count of the invalid rows, and
the null fills as ``segment.last_marked`` (a cumsum, where the JAX package
takes a cummax of indices). Float sums run in another order on the card
than XLA's CPU scan: the port's tests hold them to 1e-12·Σ|x| (float64)
and 1e-5·Σ|x| + 1e-6 (float32).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from .bits import SIGNED_OF, as_signed_bits, from_ordered_signed, \
    ordered_signed
from .segment import last_marked
from .kernel_utils import to_storage, values_of

__all__ = ["CumulativeOptions", "PairwiseOptions", "ScatterOptions"]


class CumulativeOptions:
    def __init__(self, start=None, skip_nulls: bool = False):
        self.start = start
        self.skip_nulls = skip_nulls


class PairwiseOptions:
    def __init__(self, period: int = 1):
        self.period = period


class ScatterOptions:
    def __init__(self, max_index: int = -1):
        self.max_index = max_index


def _identity(dtype: torch.dtype, op: str):
    """Arrow's identities: std::numeric_limits<T>::max() / min(); for a
    float ::min() is the smallest POSITIVE normal, not -inf
    (vector_cumulative_ops.cc CumulativeOptionsWrapper; a parity quirk)."""
    if op in ("sum", "prod"):
        return 0 if op == "sum" else 1
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        return info.max if op == "min" else info.tiny
    info = np.iinfo(np.dtype(str(dtype).replace("torch.", "")))
    return int(info.max) if op == "min" else int(info.min)


def _poison(a: Array):
    """The validity after the first null: rows before it (a running count
    of the invalid rows in range is 0)."""
    if a.validity is None:
        return None
    bad = (~a.validity & a.row_mask()).to(torch.int32)
    return torch.cumsum(bad, 0) == 0


def _scalar_like(value, v: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``v``'s dtype and device."""
    np_dtype = torch.empty(0, dtype=v.dtype).numpy().dtype
    return torch.from_numpy(np.asarray(value).astype(np_dtype)).to(v.device)


def _cumulative(a: Array, options, op: str) -> Array:
    opts = options or CumulativeOptions()
    v = a.values
    x = torch.where(a.present_mask(), v,
                    _scalar_like(_identity(v.dtype, op), v))
    start = None if opts.start is None else _scalar_like(opts.start, v)
    if op in ("sum", "prod"):
        w = as_signed_bits(x)               # wraps to the same bits
        acc = torch.cumsum(w, 0, dtype=w.dtype) if op == "sum" else \
            torch.cumprod(w, 0, dtype=w.dtype)
        if start is not None:
            s = as_signed_bits(start)
            acc = acc + s if op == "sum" else acc * s
        acc = acc.view(v.dtype)
    else:
        wide = v.dtype in SIGNED_OF
        w = ordered_signed(x) if wide else x
        acc = torch.cummin(w, 0).values if op == "min" else \
            torch.cummax(w, 0).values
        if start is not None:
            s = ordered_signed(start) if wide else start
            acc = torch.minimum(acc, s) if op == "min" else \
                torch.maximum(acc, s)
        if wide:
            acc = from_ordered_signed(acc, v.dtype)
    validity = a.validity if opts.skip_nulls else _poison(a)
    return Array(a.type, acc, validity, length=a.length)


def _cumulative_mean(a: Array, options) -> Array:
    opts = options or CumulativeOptions()
    valid = a.present_mask()
    x = torch.where(valid, values_of(a, dt.float64), 0.0)
    sums = torch.cumsum(x, 0)
    counts = torch.cumsum(valid.to(torch.int64), 0)
    mean = sums / counts.clamp(min=1).to(torch.float64)
    validity = a.validity if opts.skip_nulls else _poison(a)
    return Array(dt.float64, mean, validity, length=a.length)


for _op in ("sum", "prod", "min", "max"):
    register_function(f"cumulative_{_op}", Kind.VECTOR, 1,
                      null_handling=NullHandling.COMPUTED,
                      options_class=CumulativeOptions)(
        lambda args, options, _o=_op: _cumulative(args[0], options, _o))

register_function("cumulative_mean", Kind.VECTOR, 1,
                  null_handling=NullHandling.COMPUTED,
                  options_class=CumulativeOptions)(
    lambda args, options: _cumulative_mean(args[0], options))


def _period_source(a: Array, period: int):
    """(source row of each row, clamped; the source is in range) of a
    pairwise step."""
    cap = a.capacity
    src = torch.arange(cap, device=a.device) - int(period)
    in_rng = (src >= 0) & (src < torch.as_tensor(a.length, device=a.device))
    return src.clamp(0, max(cap - 1, 0)), in_rng


@register_function("pairwise_diff", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=PairwiseOptions)
def _pairwise_diff(args, options):
    (a,) = args
    period = options.period if options is not None else 1
    src, in_rng = _period_source(a, period)
    v = as_signed_bits(a.values)            # wraps to the same bits
    out = (v - v[src]).view(a.values.dtype)
    valid = a.validity_or_true()
    return Array(a.type, out, in_rng & valid & valid[src], length=a.length)


@register_function("replace_with_mask", Kind.VECTOR, 3,
                   null_handling=NullHandling.COMPUTED)
def _replace_with_mask(args, options):
    a, mask, repl = args
    cap = a.capacity
    m_ok = mask.validity_or_true()
    use_repl = mask.values.to(torch.bool) & m_ok & a.row_mask()
    # replacement k goes to the k-th mask-true position
    ridx = torch.cumsum(use_repl.to(torch.int32), 0) - 1
    if isinstance(repl, Scalar):
        rv = values_of(repl, a.type).to(a.device).expand(cap)
        r_ok_at = torch.full((cap,), repl.is_valid, device=a.device)
    else:
        rc = ridx.clamp(0, repl.capacity - 1)
        rv = as_signed_bits(values_of(repl, a.type))[rc]
        r_ok_at = repl.validity_or_true()[rc]
    out = torch.where(use_repl, as_signed_bits(rv),
                      as_signed_bits(a.values)).view(a.values.dtype)
    validity = torch.where(use_repl, r_ok_at, a.validity_or_true()) & m_ok
    return Array(a.type, out, validity, length=a.length)


def _fill_directional(a: Array, forward: bool) -> Array:
    """Each null row takes the last (forward) or next (backward) valid
    row's value: ``last_marked`` over the valid rows, on the reversed
    rows for backward."""
    if a.validity is None:
        return a
    from .selection import take_array
    cap = a.capacity
    valid = a.validity & a.row_mask()
    if forward:
        src = last_marked(valid)
    else:
        rev = last_marked(valid.flip(0)).flip(0)
        src = torch.where(rev >= 0, cap - 1 - rev, -1)
    has = src >= 0
    idx = torch.where(has, src, torch.arange(cap, device=a.device))
    out = take_array(a.with_validity(None),
                     Array(dt.int64, idx, None, length=a.length))
    return out.with_validity(a.validity | has)


@register_function("fill_null_forward", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _fill_null_forward(args, options):
    return _fill_directional(args[0], forward=True)


@register_function("fill_null_backward", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _fill_null_backward(args, options):
    return _fill_directional(args[0], forward=False)


@register_function("indices_nonzero", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _indices_nonzero(args, options):
    from .selection import get_take_indices
    (a,) = args
    nz = (as_signed_bits(a.values) != 0) & a.present_mask()
    idx = get_take_indices(Array(dt.bool_, nz, None, length=a.length))
    return Array(dt.uint64, to_storage(idx.values.to(torch.int64),
                                       dt.uint64), None, length=idx.length)


@register_function("scatter", Kind.VECTOR, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ScatterOptions)
def _scatter(args, options):
    """vector_swizzle.cc Scatter: out[indices[i]] = values[i]; positions
    not hit are null. A take through the inverse permutation (one unique
    scatter of int32 + one gather)."""
    from .selection import take_array
    from ..compute.registry import call_function
    values, indices = args
    inv = call_function("inverse_permutation", [indices])
    mi = options.max_index if options else -1
    if mi is not None and mi >= 0:
        if inv.capacity < mi + 1:
            from ..core.interop import pad_capacity
            cap = pad_capacity(mi + 1)
            iv = torch.zeros((cap,), dtype=torch.int32, device=inv.device)
            vv = torch.zeros((cap,), dtype=torch.bool, device=inv.device)
            iv[:inv.capacity] = as_signed_bits(inv.values).to(torch.int32)
            vv[:inv.capacity] = inv.validity_or_true()
            inv = Array(dt.int32, iv, vv, length=mi + 1)
        else:
            # positions beyond the hit range are already null-marked
            inv = inv.with_length(mi + 1)
    return take_array(values, inv)

