"""Comparison, boolean and validity kernels.

Reference: ``scalar_compare.cc``, ``scalar_boolean.cc``,
``scalar_validity.cc``; the counterpart of the JAX package's
``ops/scalar_compare.py`` for numeric, bool and temporal inputs.
"""

from __future__ import annotations

import operator

import torch

from ..core import datatype as dt
from ..compute.registry import Kind, NullHandling, register_function
from .bits import SIGNED_OF, ordered_signed, unsigned_to_int64
from .kernel_utils import (capacity_of, device_of, output_like, promote_args,
                           values_of)

__all__ = []


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
    raise TypeError(f"cannot compare {types}")


def _compare(name, op):
    @register_function(name, Kind.SCALAR, 2)
    def _fn(args, options, _op=op):
        va, vb = _comparable_values(args)
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


@register_function("invert", Kind.SCALAR, 1)
def _invert(args, options):
    return output_like(~_bool_vals(args[0], capacity_of(args),
                                   device_of(args)), dt.bool_, args)


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
