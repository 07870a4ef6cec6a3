"""Comparison, boolean (Kleene), validity and selection kernels.

Reference: ``scalar_compare.cc``, ``scalar_boolean.cc``,
``scalar_validity.cc``, ``scalar_if_else.cc`` (if_else / case_when /
coalesce / choose); the counterpart of the JAX package's
``ops/scalar_compare.py`` for numeric, bool, temporal, decimal, string and
dictionary-of-string inputs (the last two through ``ops/strings``'s exact
byte comparison).
"""

from __future__ import annotations

import operator

import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from .bits import SIGNED_OF, as_signed_bits, ordered_signed, \
    unsigned_to_int64
from .kernel_utils import (capacity_of, common_numeric_type, device_of,
                           host_to_device, length_of, output_like,
                           promote_args, torch_dtype, values_of)

__all__ = ["FillNullOptions"]


def _orderable(v: torch.Tensor) -> torch.Tensor:
    if v.dtype == torch.uint64:
        return ordered_signed(v)
    return unsigned_to_int64(v) if v.dtype in SIGNED_OF else v


def _comparable_values(args):
    """Promote comparison operands (numeric, bool, same-type temporal)."""
    types = [a.type for a in args]
    if all(isinstance(t, dt.BoolType) for t in types):
        return [values_of(a) for a in args]
    if all(t.is_numeric for t in types):
        vals, _ = promote_args(args)
        # torch has no compare for uint16 / uint32 / uint64, and on the card
        # no conversion of them either: uint16 / uint32 widen (exact) to
        # int64 through their signed bits, uint64 compares as the signed
        # value with the same order (the common type of two integers is
        # uint64 only when both are unsigned)
        return [_orderable(v) for v in vals]
    if all(t.is_temporal for t in types) and len(set(types)) == 1:
        return [values_of(a) for a in args]
    if all(isinstance(t, dt.DecimalType) for t in types) and \
            len({t.scale for t in types}) == 1:
        # scaled integers of one scale: int64, or two limbs (a scalar's
        # moved to the column's device: it is no 0-d tensor then)
        vals = [values_of(a) for a in args]
        if not any(t.wide for t in types):
            return vals
        dev = device_of(args)
        return [_limb_key(host_to_device(v, dev), t.wide)
                for v, t in zip(vals, types)]
    raise TypeError(f"cannot compare {types}")


def _limb_key(v: torch.Tensor, wide: bool) -> torch.Tensor:
    """(n, 2) int64 [high signed, low as ordered signed] of a decimal's
    storage (a scalar's: (1, 2)), whose lexicographic signed order is the
    128-bit order (torch compares no uint64 on the card)."""
    if not wide:
        v = torch.stack([v, v >> 63], dim=-1)
    v = v.reshape(-1, 2)
    return torch.stack([v[:, 1], v[:, 0] ^ torch.iinfo(torch.int64).min],
                       dim=1)


def _lex_compare(op, va: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """``op`` over the rows of two (n, 2) limb keys in lexicographic
    order."""
    if op is operator.eq:
        return (va == vb).all(dim=1)
    if op is operator.ne:
        return (va != vb).any(dim=1)
    strict = {operator.le: operator.lt, operator.ge: operator.gt}.get(op, op)
    hi_eq = va[:, 0] == vb[:, 0]
    return strict(va[:, 0], vb[:, 0]) | (hi_eq & op(va[:, 1], vb[:, 1]))


def _is_stringy(a) -> bool:
    t = a.type
    if isinstance(t, dt.DictionaryType):
        t = t.value_type
    return t.is_varlen


def _compare(name, op):
    @register_function(name, Kind.SCALAR, 2)
    def _fn(args, options, _op=op, _name=name):
        if any(_is_stringy(a) for a in args):
            from .strings import compare_varlen
            return output_like(compare_varlen(_name, args[0], args[1]),
                               dt.bool_, args)
        va, vb = _comparable_values(args)
        if va.ndim == 2:            # wide decimals: two limbs a row
            return output_like(_lex_compare(_op, va, vb), dt.bool_, args)
        return output_like(_op(va, vb), dt.bool_, args)
    return _fn


_compare("equal", operator.eq)
_compare("not_equal", operator.ne)
_compare("less", operator.lt)
_compare("less_equal", operator.le)
_compare("greater", operator.gt)
_compare("greater_equal", operator.ge)


def _bool_vals(a, cap, device):
    v = values_of(a)
    if v.ndim == 0:
        v = torch.full((cap,), bool(v), dtype=torch.bool, device=device)
    return v.to(torch.bool)


def _bool_op(name, fn):
    @register_function(name, Kind.SCALAR, 2)
    def _k(args, options, _fn=fn):
        cap, dev = capacity_of(args), device_of(args)
        vals = [_bool_vals(a, cap, dev) for a in args]
        return output_like(_fn(*vals), dt.bool_, args)
    return _k


_bool_op("and", operator.and_)
_bool_op("or", operator.or_)
_bool_op("xor", operator.xor)
_bool_op("and_not", lambda a, b: a & ~b)


@register_function("invert", Kind.SCALAR, 1)
def _invert(args, options):
    return output_like(~_bool_vals(args[0], capacity_of(args),
                                   device_of(args)), dt.bool_, args)


def _valid_mask(a, cap, device) -> torch.Tensor:
    if isinstance(a, Scalar):
        return torch.full((cap,), a.is_valid, dtype=torch.bool,
                          device=device)
    return a.validity_or_true()


def _kleene(name, fn):
    """Kleene logic (``scalar_boolean.cc``): ``fn(av, a_ok, bv, b_ok)`` ->
    (values, validity); a null operand is unknown, so ``false and null`` is
    false and ``true or null`` is true."""
    @register_function(name, Kind.SCALAR, 2,
                       null_handling=NullHandling.COMPUTED)
    def _k(args, options, _fn=fn):
        cap, dev = capacity_of(args), device_of(args)
        a, b = args
        values, validity = _fn(
            _bool_vals(a, cap, dev), _valid_mask(a, cap, dev),
            _bool_vals(b, cap, dev), _valid_mask(b, cap, dev))
        return Array(dt.bool_, values, validity, length=length_of(args))
    return _k


# false dominates null; null otherwise unless both valid
_kleene("and_kleene", lambda av, ao, bv, bo: (
    ((~ao) | av) & ((~bo) | bv), (ao & ~av) | (bo & ~bv) | (ao & bo)))
_kleene("or_kleene", lambda av, ao, bv, bo: (
    (ao & av) | (bo & bv), (ao & av) | (bo & bv) | (ao & bo)))
_kleene("and_not_kleene", lambda av, ao, bv, bo: (
    ((~ao) | av) & ((~bo) | ~bv), (ao & ~av) | (bo & bv) | (ao & bo)))


@register_function("is_null", Kind.SCALAR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL)
def _is_null(args, options):
    (a,) = args
    out = ~a.validity_or_true()
    return output_like(out, dt.bool_, args)


@register_function("is_valid", Kind.SCALAR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL)
def _is_valid(args, options):
    (a,) = args
    return output_like(a.validity_or_true(), dt.bool_, args)


def _float_test(name, fn, other: bool):
    """A float predicate; ``other`` for integer inputs."""
    @register_function(name, Kind.SCALAR, 1)
    def _f(args, options, _fn=fn, _other=other):
        (a,) = args
        v = values_of(a)
        out = _fn(v) if a.type.is_floating else torch.full_like(
            v, _other, dtype=torch.bool)
        return output_like(out, dt.bool_, args)
    return _f


_float_test("is_nan", torch.isnan, False)
_float_test("is_finite", torch.isfinite, True)
_float_test("is_inf", torch.isinf, False)


@register_function("true_unless_null", Kind.SCALAR, 1)
def _true_unless_null(args, options):
    return output_like(torch.ones((capacity_of(args),), dtype=torch.bool,
                                  device=device_of(args)), dt.bool_, args)


# ---- if_else / coalesce / case_when / choose ---------------------------------

def _common_type_of(args):
    types = [a.type for a in args]
    if all(t == types[0] for t in types):
        return types[0]
    if all(t.is_numeric for t in types):
        return common_numeric_type(types)
    raise TypeError(f"no common type among {types}")


def _column(a, t, cap, device) -> torch.Tensor:
    """``a``'s values in ``t``'s storage as a (cap,) column."""
    v = values_of(a, t)
    if v.ndim == 0:
        v = host_to_device(v, device).expand(cap)
    return v


def _where(cond, x, y):
    """torch.where for any dtype (wide unsigned ones by their bits)."""
    if x.dtype in SIGNED_OF:
        return torch.where(cond, as_signed_bits(x),
                           as_signed_bits(y)).view(x.dtype)
    return torch.where(cond, x, y)


@register_function("if_else", Kind.SCALAR, 3,
                   null_handling=NullHandling.COMPUTED)
def _if_else(args, options):
    cond, left, right = args
    cap, dev = capacity_of(args), device_of(args)
    out_t = _common_type_of([left, right])
    cv = _bool_vals(cond, cap, dev)
    values = _where(cv, _column(left, out_t, cap, dev),
                    _column(right, out_t, cap, dev))
    validity = _valid_mask(cond, cap, dev) & torch.where(
        cv, _valid_mask(left, cap, dev), _valid_mask(right, cap, dev))
    return Array(out_t, values, validity, length=length_of(args))


@register_function("coalesce", Kind.SCALAR, -1,
                   null_handling=NullHandling.COMPUTED)
def _coalesce(args, options):
    if not args:
        raise ValueError("coalesce needs at least one argument")
    cap, dev = capacity_of(args), device_of(args)
    out_t = _common_type_of(args)
    values = validity = None
    for a in args:
        v = _column(a, out_t, cap, dev)
        ok = _valid_mask(a, cap, dev)
        if values is None:
            values, validity = v, ok
        else:
            values = _where((~validity) & ok, v, values)
            validity = validity | ok
    return Array(out_t, values, validity, length=length_of(args))


class FillNullOptions:
    def __init__(self, value=None):
        self.value = value


@register_function("fill_null", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _fill_null(args, options):
    a, fill = args
    cap, dev = capacity_of([a]), device_of([a])
    out_t = _common_type_of([a, fill])
    ok = _valid_mask(a, cap, dev)
    values = _where(ok, _column(a, out_t, cap, dev),
                    _column(fill, out_t, cap, dev))
    return Array(out_t, values, ok | _valid_mask(fill, cap, dev),
                 length=length_of([a]))


def _select(hits, choices, out_t, cap, dev):
    """Per row the value and validity of the choice whose hit mask is set
    (the masks exclude each other; no hit: a null 0)."""
    values = torch.zeros((cap,), dtype=torch_dtype(out_t), device=dev)
    validity = torch.zeros((cap,), dtype=torch.bool, device=dev)
    for hit, c in zip(hits, choices):
        values = _where(hit, _column(c, out_t, cap, dev), values)
        validity = torch.where(hit, _valid_mask(c, cap, dev), validity)
    return values, validity


@register_function("case_when", Kind.SCALAR, -1,
                   null_handling=NullHandling.COMPUTED)
def _case_when(args, options):
    """case_when(cond_struct, *cases[, else]) — first-true-wins. The
    condition "struct" is a Batch of bool columns (structs surface as
    batches in this engine); a null condition counts as not-matched
    (``scalar_if_else.cc`` CaseWhen semantics)."""
    from ..core.batch import Batch
    conds = args[0]
    if not isinstance(conds, Batch):
        raise TypeError("case_when: first argument must be a batch/struct "
                        "of bool conditions")
    cases = args[1:]
    ncond = conds.num_columns
    has_else = len(cases) == ncond + 1
    if not (len(cases) == ncond or has_else):
        raise ValueError("case_when: need one case per condition "
                         "(+ optional else)")
    cap, dev = conds.capacity, conds.device
    out_t = _common_type_of([c for c in cases if isinstance(c, Array)] or
                            list(cases))
    decided = torch.zeros((cap,), dtype=torch.bool, device=dev)
    hits = []
    for i in range(ncond):
        c = conds.column(i)
        hit = ~decided & c.validity_or_true() & c.values.to(torch.bool)
        hits.append(hit)
        decided = decided | hit
    if has_else:
        hits.append(~decided)
    values, validity = _select(hits, cases, out_t, cap, dev)
    return Array(out_t, values, validity, length=conds.length)


@register_function("choose", Kind.SCALAR, -1,
                   null_handling=NullHandling.COMPUTED)
def _choose(args, options):
    """choose(indices, *values): per-row select of the i-th value arg."""
    idx, choices = args[0], args[1:]
    cap, dev = idx.capacity, idx.device
    out_t = _common_type_of([c for c in choices if isinstance(c, Array)] or
                            list(choices))
    iv = as_signed_bits(idx.values).to(torch.int64)
    values, validity = _select([iv == i for i in range(len(choices))],
                                     choices, out_t, cap, dev)
    return Array(out_t, values, validity & _valid_mask(idx, cap, dev),
                 length=idx.length)
