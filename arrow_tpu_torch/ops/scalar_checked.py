"""Checked arithmetic kernels (``*_checked``): raise on data-dependent
errors; the counterpart of the JAX package's ``ops/scalar_checked.py``.

Reference: ``cpp/src/arrow/compute/kernels/scalar_arithmetic.cc:339``: the
checked kernel variants error with ``ArrowInvalid`` on integer overflow,
divide-by-zero and float domain errors, where the unchecked variants wrap
or produce NaN / inf (``shift_left_checked`` checks only the shift
amount; float ``add_checked`` checks no overflow).

Each kernel computes its output with wraparound arithmetic, as
``ops/scalar_arithmetic.py`` does (integers in an int64 work dtype, wide
unsigned by their bits, written back in their own width), plus a per-row
error mask; the mask is reduced over the in-range valid rows to one flag,
which ``utils.errors.check`` reads: one reduction and one host read a
check.

Overflow tests: a type narrower than 64 bits is computed exactly in int64
and compared with its range, except a uint32 product, which can pass 2^63
and is tested by division (``b > max // a``); int64 uses the wraparound
identities and a truncated division, uint64 unsigned compares and
``scalar_arithmetic._udiv64``.

Float results may differ from XLA's CPU by an ulp (torch's libm on the
CPU, CUDA's on the card): the port's tests allow 2 ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from ..utils import errors
from .kernel_utils import (common_numeric_type, device_of,
                           output_like, to_storage, values_of)
from .scalar_arithmetic import _divide, _int_divide, _is_u64, _shift, \
    _uge, _udiv64, _work
from .vector_misc import CumulativeOptions, PairwiseOptions, _cumulative, \
    _pairwise_diff

__all__ = []

_OVERFLOW = "overflow"
_DIV_ZERO = "divide by zero"
_DOMAIN = "domain error"
_LOG_ZERO = "logarithm of zero"
_LOG_NEG = "logarithm of negative number"
_SQRT_NEG = "square root of negative number"
_NEG_POW = "integers to negative integer powers are not allowed"
_SHIFT_RANGE = "shift amount must be >= 0 and less than precision of type"


def _any_bad(bad, args) -> torch.Tensor:
    """Reduce a per-row error mask over in-range, all-valid rows."""
    for a in args:
        if isinstance(a, Scalar) and not a.is_valid:
            return torch.tensor(False)   # null scalar -> all-null result
    arr = next(a for a in args if isinstance(a, Array))
    m = bad & arr.row_mask()
    for a in args:
        if isinstance(a, Array) and a.validity is not None:
            m = m & a.validity
    return m.any()


def _range(t: dt.DataType):
    info = np.iinfo(t.storage_np)
    return int(info.min), int(info.max)


def _wrap(x: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """int64 work values wrapped to ``t``'s width, as work values again
    (signed: sign-extended; unsigned: by value; 64-bit: as they are)."""
    if t.bit_width == 64:
        return x
    bits = t.bit_width
    lo = x & ((1 << bits) - 1)
    return lo - ((lo >> (bits - 1)) << bits) if t.signed else lo


def _narrow_ovf(exact: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    lo, hi = _range(t)
    return (exact < lo) | (exact > hi)


def _add(a, b, t):
    """(a + b wrapped, overflow) of work values."""
    s = a + b
    if t.bit_width < 64:
        return _wrap(s, t), _narrow_ovf(s, t)
    if t.signed:
        return s, ((~(a ^ b)) & (a ^ s)) < 0
    return s, ~_uge(s, a)


def _sub(a, b, t):
    d = a - b
    if t.bit_width < 64:
        return _wrap(d, t), _narrow_ovf(d, t)
    if t.signed:
        return d, ((a ^ b) & (a ^ d)) < 0
    return d, ~_uge(a, b)


def _mul(a, b, t):
    p = a * b
    bits = t.bit_width
    if bits < 32 or (bits == 32 and t.signed):
        return _wrap(p, t), _narrow_ovf(p, t)   # exact in int64
    if bits == 32:
        # a uint32 product can pass 2^63: b > max // a
        safe = torch.where(a == 0, 1, a)
        return _wrap(p, t), (a != 0) & (b > (0xFFFFFFFF // safe))
    if t.signed:
        imin = -(1 << 63)
        safe = torch.where((a == 0) | (a == -1), 1, a)
        q = _int_divide(p, safe, t)
        return p, torch.where(a == 0, False,
                              torch.where(a == -1, b == imin, q != b))
    safe = torch.where(a == 0, 1, a)
    return p, torch.where(a == 0, False, _udiv64(p, safe) != b)


def _work64(x, t: dt.DataType, device) -> torch.Tensor:
    """``x``'s values as work values: a float in its own type, an integer
    by value in int64 (uint64 by its bits)."""
    v = _work(x, t, device)
    return v if t.is_floating else v.to(torch.int64)


def _out(v: torch.Tensor, t: dt.DataType, args) -> Array:
    return output_like(to_storage(v, t) if t.is_integer else v, t, args)


# ---- binary checked arithmetic ---------------------------------------------

def _binary_checked(name, op):
    @register_function(name, Kind.SCALAR, 2,
                       doc=f"{name[:-8]} raising ArrowInvalid on overflow")
    def _fn(args, options, _op=op):
        t = common_numeric_type([x.type for x in args])
        a, b = (_work64(x, t, device_of(args)) for x in args)
        if not t.is_integer:
            return _out(_FLOAT_OPS[_op](a, b), t, args)
        out, ovf = _op(a, b, t)
        errors.check(_any_bad(ovf, args), _OVERFLOW)
        return _out(out, t, args)
    return _fn


_FLOAT_OPS = {_add: torch.add, _sub: torch.sub, _mul: torch.mul}
_binary_checked("add_checked", _add)
_binary_checked("subtract_checked", _sub)
_binary_checked("multiply_checked", _mul)


@register_function("divide_checked", Kind.SCALAR, 2)
def _divide_checked(args, options):
    t = common_numeric_type([x.type for x in args])
    a, b = (_work64(x, t, device_of(args)) for x in args)
    out = _divide(a, b, t)
    errors.check(_any_bad(b == 0, args), _DIV_ZERO)
    if t.is_signed_integer:
        lo, _ = _range(t)
        errors.check(_any_bad((a == lo) & (b == -1), args), _OVERFLOW)
    return _out(out, t, args)


def _shift_checked(name, left: bool):
    @register_function(name, Kind.SCALAR, 2)
    def _fn(args, options, _left=left):
        t = common_numeric_type([x.type for x in args])
        a, b = (_work64(x, t, device_of(args)) for x in args)
        # Arrow's bound is std::numeric_limits<T>::digits: value bits
        # excluding the sign bit (scalar_arithmetic.cc ShiftLeftChecked)
        digits = t.bit_width - (1 if t.signed else 0)
        errors.check(_any_bad((b < 0) | (b >= digits), args), _SHIFT_RANGE)
        bc = b.clamp(0, t.bit_width - 1)
        # a narrow type shifts as int64 work values, wrapped to its width
        work_t = t if t.bit_width == 64 else dt.int64
        return _out(_shift(a, bc, work_t, _left), t, args)
    return _fn


_shift_checked("shift_left_checked", True)
_shift_checked("shift_right_checked", False)


@register_function("power_checked", Kind.SCALAR, 2)
def _power_checked(args, options):
    t = common_numeric_type([x.type for x in args])
    a, b = (_work64(x, t, device_of(args)) for x in args)
    if not t.is_integer:
        return _out(torch.pow(a, b), t, args)
    neg = b < 0 if t.signed else torch.zeros_like(b, dtype=torch.bool)
    errors.check(_any_bad(neg, args), _NEG_POW)
    out, ovf = _int_pow_checked(a, b.clamp(min=0) if t.signed else b, t)
    errors.check(_any_bad(ovf, args), _OVERFLOW)
    return _out(out, t, args)


def _int_pow_checked(a, e, t):
    """Exponentiation by squaring with per-multiply overflow detection.

    |base| >= 2 with exponent > 63 always overflows, so the live squaring
    loop only needs the low 6 exponent bits; bases in {-1, 0, 1} are
    closed-form for any exponent."""
    if _is_u64(t):
        big = ~_uge(torch.full_like(e, 63), e)
    else:
        big = e > 63
    ec = torch.where(big, 0, e)
    result = torch.ones_like(a)
    base = a
    ovf = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for i in range(6):
        bit = ((ec >> i) & 1) == 1
        nr, o = _mul(result, base, t)
        ovf = ovf | (bit & o)
        result = torch.where(bit, nr, result)
        more = (ec >> (i + 1)) > 0
        nb, o = _mul(base, base, t)
        ovf = ovf | (more & o)
        base = torch.where(more, nb, base)
    small_base = (a == 0) | (a == 1) | ((a == -1) if t.signed else False)
    small = torch.where(a == 0, (e == 0).to(a.dtype),
                        torch.where((a < 0) & ((e & 1) == 1), -1, 1)
                        .to(a.dtype))
    out = torch.where(small_base, small, torch.where(big, 0, result))
    ovf = torch.where(small_base, False, ovf | big)
    return out, ovf


# ---- unary checked arithmetic ----------------------------------------------

@register_function("negate_checked", Kind.SCALAR, 1)
def _negate_checked(args, options):
    (a,) = args
    t = a.type
    if t.is_integer and not t.signed:
        raise TypeError(
            "Function 'negate_checked' has no kernel matching input types "
            f"({t})")
    v = _work64(a, t, device_of(args))
    if t.is_integer:
        errors.check(_any_bad(v == _range(t)[0], args), _OVERFLOW)
        return _out(-v, t, args)
    return _out(-v, t, args)


@register_function("abs_checked", Kind.SCALAR, 1)
def _abs_checked(args, options):
    (a,) = args
    t = a.type
    v = _work64(a, t, device_of(args))
    if t.is_integer and not t.signed:
        return _out(v, t, args)        # |x| of an unsigned x is x
    if t.is_integer:
        errors.check(_any_bad(v == _range(t)[0], args), _OVERFLOW)
    return _out(v.abs(), t, args)


def _unary_float_checked(name, op, bad_fn):
    """Float-domain checked function; ``bad_fn(v)`` yields [(mask,
    message), ...] in raise-priority order."""
    @register_function(name, Kind.SCALAR, 1)
    def _fn(args, options, _op=op, _bad=bad_fn):
        (a,) = args
        out_t = a.type if a.type.is_floating else dt.float64
        v = values_of(a, out_t)
        for mask, msg in _bad(v):
            errors.check(_any_bad(mask, args), msg)
        return output_like(_op(v), out_t, args)
    return _fn


_unary_float_checked("sqrt_checked", torch.sqrt,
                     lambda v: [(v < 0, _SQRT_NEG)])
for _n, _o in (("ln_checked", torch.log), ("log2_checked", torch.log2),
               ("log10_checked", torch.log10)):
    _unary_float_checked(_n, _o, lambda v: [(v < 0, _LOG_NEG),
                                            (v == 0, _LOG_ZERO)])
_unary_float_checked("log1p_checked", torch.log1p,
                     lambda v: [(v < -1, _LOG_NEG), (v == -1, _LOG_ZERO)])
for _n, _o in (("sin_checked", torch.sin), ("cos_checked", torch.cos),
               ("tan_checked", torch.tan)):
    _unary_float_checked(_n, _o, lambda v: [(torch.isinf(v), _DOMAIN)])
for _n, _o in (("asin_checked", torch.asin), ("acos_checked", torch.acos)):
    _unary_float_checked(_n, _o, lambda v: [(v.abs() > 1, _DOMAIN)])
_unary_float_checked("atanh_checked", torch.atanh,
                     lambda v: [(v.abs() >= 1, _DOMAIN)])
_unary_float_checked("acosh_checked", torch.acosh,
                     lambda v: [(v < 1, _DOMAIN)])


@register_function("logb_checked", Kind.SCALAR, 2)
def _logb_checked(args, options):
    t = common_numeric_type([x.type for x in args])
    if not t.is_floating:
        t = dt.float64
    dev = device_of(args)
    x, b = (values_of(v, t).to(dev) for v in args)
    errors.check(_any_bad((x < 0) | (b < 0), args), _LOG_NEG)
    errors.check(_any_bad((x == 0) | (b == 0), args), _LOG_ZERO)
    return output_like(torch.log(x) / torch.log(b), t, args)


# ---- checked vector ops (cumulative / pairwise) ----------------------------

def _register_cumulative_checked(op):
    @register_function(f"cumulative_{op}_checked", Kind.VECTOR, 1,
                       null_handling=NullHandling.COMPUTED,
                       options_class=CumulativeOptions)
    def _fn(args, options, _op=op):
        (a,) = args
        out = _cumulative(a, options, _op)
        t = a.type
        if not t.is_integer:
            return out
        dev = a.device
        x = torch.where(a.present_mask(), _work64(a, t, dev),
                        0 if _op == "sum" else 1)
        acc = _work64(out, t, dev)
        opts = options or CumulativeOptions()
        start = None if opts.start is None else torch.tensor(
            [int(np.asarray(opts.start).astype(t.storage_np)
                 .astype(np.int64))], device=dev)   # uint64: its bits
        if _op == "sum":
            base = acc if start is None else _sub(acc, start, t)[0]
            prev = _sub(base, x, t)[0]   # wraparound-exact inverse step
            bad = _add(prev, x, t)[1]
            if start is not None:
                bad = bad | _add(base, start.expand_as(base), t)[1]
        else:
            init = torch.ones((1,), dtype=acc.dtype, device=dev) \
                if start is None else start
            prev = torch.cat([init, acc[:-1]])
            bad = _mul(prev, x, t)[1]
        if out.validity is not None:
            bad = bad & out.validity     # the poisoned tail was not computed
        errors.check(_any_bad(bad, args), _OVERFLOW)
        return out
    return _fn


_register_cumulative_checked("sum")
_register_cumulative_checked("prod")


@register_function("pairwise_diff_checked", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=PairwiseOptions)
def _pairwise_diff_checked(args, options):
    (a,) = args
    out = _pairwise_diff(args, options)
    t = a.type
    if t.is_integer:
        period = options.period if options is not None else 1
        cap = a.capacity
        src = (torch.arange(cap, device=a.device) - int(period)).clamp(
            0, max(cap - 1, 0))
        v = _work64(a, t, a.device)
        bad = _sub(v, v[src], t)[1]
        if out.validity is not None:
            bad = bad & out.validity
        errors.check(_any_bad(bad, args), _OVERFLOW)
    return out
