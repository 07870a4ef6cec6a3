"""Scalar arithmetic kernels (elementwise).

Reference: ``cpp/src/arrow/compute/kernels/scalar_arithmetic.cc`` and
``scalar_math.cc``; the counterpart of the JAX package's
``ops/scalar_arithmetic.py``, with its results: integers wrap like C on
overflow (Arrow's non-``_checked`` kernels), integer division truncates,
and the integer corner cases (division by zero, ``x ** negative``, shifts
out of range) give what the JAX package's jnp ops give.

torch has no arithmetic, compare or shift for uint16 / uint32 / uint64 on
the card, so a wide unsigned result is computed in int64 (the operands by
value, uint64 by its bits: ``bits.unsigned_to_int64``) and written back in
its own width by its low bits; division, order and shifts of uint64 bits
take the unsigned forms below.
"""

from __future__ import annotations

import torch

from ..core import datatype as dt
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from .bits import SIGNED_OF, unsigned_to_int64
from .kernel_utils import (capacity_of, common_numeric_type, device_of,
                           host_to_device, output_like, to_storage,
                           torch_dtype, values_of)

__all__ = ["ElementWiseAggregateOptions", "RoundOptions",
           "RoundToMultipleOptions"]

_I64_MIN = -(1 << 63)


def _work(a, t: dt.DataType, device) -> torch.Tensor:
    """``a``'s values in the work dtype of type ``t`` (a scalar as a 0-d
    tensor on ``device``)."""
    if torch_dtype(t) in SIGNED_OF:
        v = values_of(a)
        v = unsigned_to_int64(v) if v.dtype in SIGNED_OF \
            else v.to(torch.int64)
    else:
        v = values_of(a, t)
    return host_to_device(v, device) if v.ndim == 0 else v


def _is_u64(t: dt.DataType) -> bool:
    return torch_dtype(t) == torch.uint64


def _uge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a >= b for u64 bits held in int64."""
    return (a ^ _I64_MIN) >= (b ^ _I64_MIN)


def _udiv64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned 64-bit a // b of bits held in int64 (b != 0): halve a so
    that a signed division is exact, then one correction step."""
    big = b < 0                                   # b >= 2^63
    bp = torch.where(big, 1, b)
    half = (a >> 1) & ((1 << 63) - 1)
    q = torch.div(half, bp, rounding_mode="trunc") << 1
    q = q + _uge(a - q * bp, bp).to(torch.int64)
    return torch.where(big, _uge(a, b).to(torch.int64), q)


def _int_divide(a: torch.Tensor, b: torch.Tensor, t: dt.DataType):
    """Truncated integer division as the JAX package computes it: x / 0 is
    1 for a negative x and 0 otherwise; MIN / -1 wraps to MIN."""
    zero = b == 0
    if _is_u64(t):
        return torch.where(zero, 0, _udiv64(a, torch.where(zero, 1, b)))
    special = zero | ((a == torch.iinfo(a.dtype).min) & (b == -1))
    q = torch.div(a, torch.where(special, 1, b), rounding_mode="trunc")
    return torch.where(zero, (a < 0).to(q.dtype), q)


def _divide(a, b, t):
    if t.is_floating:
        return a / b
    return _int_divide(a, b, t)


def _pow(a, b, t):
    if t.is_floating:
        return torch.pow(a, b)
    # jnp's integer power: binary exponentiation over the exponent's low 6
    # bits (anything more overflows for a base > 1)
    acc = torch.where((a == 0) & (b != 0), 0, 1).to(a.dtype)
    x = a
    for k in range(6):
        acc = torch.where(((b >> k) & 1) != 0, acc * x, acc)
        x = x * x
    return acc


def _shift(a, b, t, left: bool):
    """Shifts with XLA's out-of-range rule: an amount outside [0, bits)
    gives 0, or the sign fill for an arithmetic right shift."""
    bits = t.bit_width
    ok = (b >= 0) & (b < bits)
    s = torch.where(ok, b, 0)
    if left:
        return torch.where(ok, a << s, 0)
    if _is_u64(t):
        # logical shift of u64 bits: clear the sign bits the shift copied
        keep = torch.where(s == 0, -1, ((1 << 62) >> (s - 1)) * 2 - 1)
        return torch.where(ok, (a >> s) & keep, 0)
    fill = (a < 0).to(a.dtype) * -1 if t.is_signed_integer else 0
    return torch.where(ok, a >> s, fill)


def _binary_arith(name, op, force_float=False, doc=""):
    @register_function(name, Kind.SCALAR, 2, doc=doc)
    def _fn(args, options, _op=op, _ff=force_float):
        out_t = common_numeric_type([a.type for a in args])
        if _ff and not out_t.is_floating:
            out_t = dt.float64
        dev = device_of(args)
        a, b = (_work(x, out_t, dev) for x in args)
        return output_like(to_storage(_op(a, b, out_t), out_t), out_t, args)
    return _fn


_binary_arith("add", lambda a, b, t: a + b,
              doc="a + b (wraps on int overflow)")
_binary_arith("subtract", lambda a, b, t: a - b, doc="a - b")
_binary_arith("multiply", lambda a, b, t: a * b, doc="a * b")
_binary_arith("divide", _divide, doc="a / b (int: truncated)")
_binary_arith("power", _pow, doc="a ** b")
_binary_arith("atan2", lambda a, b, t: torch.atan2(a, b), force_float=True)
_binary_arith("logb", lambda a, b, t: torch.log(a) / torch.log(b),
              force_float=True)
_binary_arith("hypot", lambda a, b, t: torch.hypot(a, b), force_float=True)
_binary_arith("bit_wise_and", lambda a, b, t: a & b)
_binary_arith("bit_wise_or", lambda a, b, t: a | b)
_binary_arith("bit_wise_xor", lambda a, b, t: a ^ b)
_binary_arith("shift_left", lambda a, b, t: _shift(a, b, t, True))
_binary_arith("shift_right", lambda a, b, t: _shift(a, b, t, False))


@register_function("mod", Kind.SCALAR, 2,
                   doc="C-style remainder (sign of dividend)")
def _mod(args, options):
    out_t = common_numeric_type([x.type for x in args])
    dev = device_of(args)
    a, b = (_work(x, out_t, dev) for x in args)
    if out_t.is_floating:
        out = torch.fmod(a, b)
    else:
        out = a - _int_divide(a, b, out_t) * torch.where(b == 0, 1, b)
    return output_like(to_storage(out, out_t), out_t, args)


class ElementWiseAggregateOptions:
    """``compute/api_scalar.h`` ElementWiseAggregateOptions."""

    def __init__(self, skip_nulls: bool = True):
        self.skip_nulls = skip_nulls


def _minmax_element_wise(name, is_max: bool):
    @register_function(name, Kind.SCALAR, -1,
                       null_handling=NullHandling.COMPUTED,
                       options_class=ElementWiseAggregateOptions,
                       doc="per-row min/max across args; skip_nulls=True "
                           "(default) ignores null slots — "
                           "scalar_compare.cc:915")
    def _fn(args, options, _max=is_max):
        skip = options is None or getattr(options, "skip_nulls", True)
        out_t = common_numeric_type([a.type for a in args])
        dev = device_of(args)
        cap = capacity_of(args)
        # u64 bits compare in the order of bits ^ sign bit
        flip = _I64_MIN if _is_u64(out_t) else 0
        op = torch.maximum if _max else torch.minimum
        out = valid = None
        for a in args:
            v = _work(a, out_t, dev) ^ flip if flip else _work(a, out_t, dev)
            v = v.expand(cap) if v.ndim == 0 else v
            if isinstance(a, Scalar):
                pm = None if a.is_valid else torch.zeros(
                    (cap,), dtype=torch.bool, device=dev)
            else:
                pm = a.validity
            if out is None:
                out, valid = v, pm
                continue
            if not skip:
                out = op(out, v)
                if pm is not None:
                    valid = pm if valid is None else valid & pm
            elif valid is None and pm is None:
                out = op(out, v)
            else:
                # null slots lose to any valid slot
                av = torch.ones_like(v, dtype=torch.bool) if valid is None \
                    else valid
                bv = torch.ones_like(v, dtype=torch.bool) if pm is None \
                    else pm
                picked = op(torch.where(av, out, v), torch.where(bv, v, out))
                out = torch.where(av & ~bv, out,
                                  torch.where(bv & ~av, v, picked))
                valid = av | bv
        if flip:
            out = out ^ flip
        return output_like(to_storage(out, out_t), out_t, args, validity=valid)
    return _fn


_minmax_element_wise("max_element_wise", True)
_minmax_element_wise("min_element_wise", False)


def _unary_arith(name, op, doc=""):
    """Unary op in the input's own type."""
    @register_function(name, Kind.SCALAR, 1, doc=doc)
    def _fn(args, options, _op=op):
        (a,) = args
        t = a.type
        v = _work(a, t, device_of(args))
        return output_like(to_storage(_op(v, t), t), t, args)
    return _fn


def _float_only(fn):
    """A rounding op: the identity on integers."""
    return lambda v, t: fn(v) if t.is_floating else v


_unary_arith("negate", lambda v, t: -v)
# the absolute value of an unsigned integer is itself
_unary_arith("abs", lambda v, t: v if t.is_unsigned_integer else v.abs())
_unary_arith("bit_wise_not", lambda v, t: ~v)
_unary_arith("floor", _float_only(torch.floor))
_unary_arith("ceil", _float_only(torch.ceil))
_unary_arith("trunc", _float_only(torch.trunc))


@register_function("sign", Kind.SCALAR, 1,
                   doc="-1/0/1; int8 for integer input, same type for "
                       "float (NaN -> NaN) — scalar_arithmetic.cc Sign")
def _sign(args, options):
    (a,) = args
    t = a.type
    v = _work(a, t, device_of(args))
    if t.is_floating:
        # NaN and signed zeros stay as they are (torch.sign gives 0 for NaN)
        out, out_t = torch.where((v == 0) | v.isnan(), v, torch.sign(v)), t
    elif t.is_unsigned_integer:
        out, out_t = (v != 0).to(torch.int8), dt.int8
    else:
        out, out_t = torch.sign(v).to(torch.int8), dt.int8
    return output_like(out, out_t, args)


def _unary_float(name, op, doc=""):
    """Unary op whose output is always float (ln, sqrt, trig...). Arrow
    promotes integer inputs to double for these."""
    @register_function(name, Kind.SCALAR, 1, doc=doc)
    def _fn(args, options, _op=op):
        (a,) = args
        out_t = a.type if a.type.is_floating else dt.float64
        return output_like(_op(values_of(a, out_t)), out_t, args)
    return _fn


for _name, _op in (("sqrt", torch.sqrt), ("exp", torch.exp),
                   ("expm1", torch.expm1), ("ln", torch.log),
                   ("log2", torch.log2), ("log10", torch.log10),
                   ("log1p", torch.log1p), ("sin", torch.sin),
                   ("cos", torch.cos), ("tan", torch.tan),
                   ("asin", torch.asin), ("acos", torch.acos),
                   ("atan", torch.atan), ("sinh", torch.sinh),
                   ("cosh", torch.cosh), ("tanh", torch.tanh),
                   ("asinh", torch.asinh), ("acosh", torch.acosh),
                   ("atanh", torch.atanh)):
    _unary_float(_name, _op)


class RoundOptions:
    def __init__(self, ndigits: int = 0, round_mode: str = "half_to_even"):
        self.ndigits = ndigits
        self.round_mode = round_mode


def _round_scaled(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "half_to_even":
        return torch.round(x)       # banker's rounding, Arrow's default
    if mode == "down":
        return torch.floor(x)
    if mode == "up":
        return torch.ceil(x)
    if mode == "towards_zero":
        return torch.trunc(x)
    if mode == "towards_infinity":
        return torch.where(x >= 0, torch.ceil(x), torch.floor(x))
    if mode == "half_down":
        return torch.ceil(x - 0.5)
    if mode == "half_up":
        return torch.floor(x + 0.5)
    if mode == "half_towards_zero":
        return torch.where(x >= 0, torch.ceil(x - 0.5), torch.floor(x + 0.5))
    if mode == "half_towards_infinity":
        return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
    raise ValueError(f"unknown round_mode {mode}")


def _round_values(v: torch.Tensor, ndigits: int, mode: str) -> torch.Tensor:
    scale = 10.0 ** ndigits
    return _round_scaled(v * scale, mode) / scale


@register_function("round", Kind.SCALAR, 1, options_class=RoundOptions)
def _round(args, options):
    (a,) = args
    opts = options or RoundOptions()
    if not a.type.is_floating:
        return output_like(values_of(a), a.type, args)
    return output_like(_round_values(values_of(a), opts.ndigits,
                                     opts.round_mode), a.type, args)


class RoundToMultipleOptions:
    def __init__(self, multiple=1.0, round_mode: str = "half_to_even"):
        self.multiple = multiple
        self.round_mode = round_mode


@register_function("round_to_multiple", Kind.SCALAR, 1,
                   options_class=RoundToMultipleOptions)
def _round_to_multiple(args, options):
    (a,) = args
    opts = options or RoundToMultipleOptions()
    m = float(opts.multiple)
    v = values_of(a, dt.float64)
    out = _round_scaled(v / m, opts.round_mode) * m
    out_t = a.type if a.type.is_floating else dt.float64
    return output_like(out.to(torch_dtype(out_t)), out_t, args)


@register_function("round_binary", Kind.SCALAR, 2,
                   options_class=RoundOptions)
def _round_binary(args, options):
    """Per-element ndigits round (``scalar_round_arithmetic.cc``
    round_binary): scale = 10^ndigits[i] per row."""
    a, nd = args
    opts = options or RoundOptions()
    mode = opts.round_mode
    if not a.type.is_floating:
        return output_like(values_of(a), a.type, args)
    v = values_of(a)
    ndv = values_of(nd).to(device=v.device, dtype=v.dtype)
    scale = torch.pow(torch.tensor(10.0, dtype=v.dtype, device=v.device),
                      ndv)
    if mode not in ("down", "up", "towards_zero"):
        mode = "half_to_even"
    return output_like(_round_scaled(v * scale, mode) / scale, a.type, args)
