"""Bit-lane extraction for key normalization (grouping, sorting, join keys).

The counterpart of ``value_lanes32``, ``ascending_lanes32`` and ``join_u32``
in the JAX package's ``ops/bits.py``.
Lanes are u32 values held in int64 tensors (torch has no add, shift,
compare or min on uint32), so every lane value is in [0, 2^32) and int64
order equals the u32 order. Group equality is Arrow's byte equality:
-0.0 != 0.0; NaNs are canonicalized to one quiet NaN, as in the JAX
package. torch has real IEEE float64 on every device, so f64 lanes are its
exact bits.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core import datatype as dt

__all__ = ["U32", "SIGNED_OF", "as_signed_bits", "as_i32", "gather_rows",
           "ordered_signed", "from_ordered_signed", "unsigned_to_int64",
           "split_u64", "join_u32", "value_lanes32", "ascending_lanes32",
           "lane_windows", "zeros_of", "FLOAT_KEY", "float_extreme_key",
           "float_from_extreme_key"]

U32 = 0xFFFFFFFF
_BIAS32 = 0x80000000
_QNAN64 = 0x7FF8000000000000

# torch's unsigned types wider than 8 bits (newer releases only) and the
# signed type of the same width: they have no index_copy_, scatter_reduce_,
# cumsum or min, and on the card no gather or arithmetic either, so they are
# moved as the signed type with the same bits, ordered as the signed value
# ``bits ^ sign bit`` and computed with as int64.
SIGNED_OF = {getattr(torch, "u" + n): getattr(torch, n)
             for n in ("int16", "int32", "int64") if hasattr(torch, "u" + n)}


# the signed integer type of a float's width: a min / max over floats runs
# on its order-preserving keys (``float_extreme_key``)
FLOAT_KEY = {torch.float16: torch.int16, torch.float32: torch.int32,
             torch.float64: torch.int64}


def float_extreme_key(x: torch.Tensor, is_min: bool) -> torch.Tensor:
    """Order-preserving signed keys of a float tensor for a min (max) that
    skips NaN, as pyarrow's does: a number's key orders as the number; a
    NaN's key loses to every number and wins only against the identity
    (the key type's largest (smallest) value, which no float maps to), so
    a group whose values are all NaN gives NaN, an empty one the
    identity."""
    kt = FLOAT_KEY[x.dtype]
    i = x.view(kt)
    k = torch.where(i >= 0, i, i ^ torch.iinfo(kt).max)
    # the key of the canonical positive NaN is above +inf's; its
    # complement, the key of the negative one, below -inf's
    nan_key = {torch.int16: 0x7E00, torch.int32: 0x7FC00000,
               torch.int64: _QNAN64}[kt]
    return torch.where(torch.isnan(x), nan_key if is_min else ~nan_key, k)


def float_from_extreme_key(k: torch.Tensor, is_min: bool,
                           dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``float_extreme_key``: the identity becomes +inf (-inf),
    a NaN key the canonical NaN."""
    i = torch.where(k >= 0, k, k ^ torch.iinfo(k.dtype).max)
    x = i.view(dtype)
    ident = torch.iinfo(k.dtype).max if is_min else torch.iinfo(k.dtype).min
    x = torch.where(k == ident, float("inf") if is_min else float("-inf"), x)
    return torch.where(torch.isnan(x), float("nan"), x)


def zeros_of(np_dtype, n: int, device) -> torch.Tensor:
    """``n`` zeros of a numpy dtype's torch counterpart, made on
    ``device`` (an unsigned type as the signed type with its bits)."""
    td = torch.from_numpy(np.empty(0, np_dtype)).dtype
    return torch.zeros((n,), dtype=SIGNED_OF.get(td, td),
                       device=device).view(td)


def as_signed_bits(x: torch.Tensor) -> torch.Tensor:
    """A uint16 / uint32 / uint64 tensor viewed as the signed type with the
    same bits (no copy); any other tensor unchanged."""
    signed = SIGNED_OF.get(x.dtype)
    return x if signed is None else x.view(signed)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along axis 0, for wide unsigned types too."""
    return as_signed_bits(x)[idx].view(x.dtype)


def unsigned_to_int64(x: torch.Tensor) -> torch.Tensor:
    """uint16 / uint32 -> int64 by value; uint64 -> the int64 with the same
    bits (so sums and differences are right mod 2^64)."""
    s = as_signed_bits(x).to(torch.int64)
    bits = 8 * x.element_size()
    return s if bits == 64 else s & ((1 << bits) - 1)


def ordered_signed(x: torch.Tensor) -> torch.Tensor:
    """uint16 / uint32 / uint64 -> the signed tensor of the same width whose
    order is the unsigned order (``bits ^ sign bit``: 0 becomes the signed
    minimum, the unsigned maximum the signed maximum)."""
    signed = SIGNED_OF[x.dtype]
    return x.view(signed) ^ torch.iinfo(signed).min


def from_ordered_signed(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``ordered_signed``: back to the unsigned ``dtype``."""
    return (s ^ torch.iinfo(s.dtype).min).view(dtype)


def split_u64(x: torch.Tensor) -> List[torch.Tensor]:
    """[hi, lo] u32 lanes (int64) of a 64-bit integer tensor (a uint64
    tensor by its bits)."""
    x = as_signed_bits(x).to(torch.int64)
    return [(x >> 32) & U32, x & U32]


def join_u32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The int64 whose bits are the u64 ``hi << 32 | lo`` of two u32 lanes."""
    return (hi << 32) | lo


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> the int32 value with the same bits (int64)."""
    return ((x & U32) ^ _BIAS32) - _BIAS32


def lane_windows(lanes: torch.Tensor, active: torch.Tensor):
    """Per-lane (lo, span) of the active rows of a (n, L) u32-lane matrix:
    the tighter of the unsigned and the signed window. ``(lane - lo) mod
    2^32`` maps either window one to one onto [0, span], so signed windows
    range-pack too. With no active row span is 1 and lo 0xFFFFFFFF."""
    act2 = active[:, None]
    lo_u = torch.where(act2, lanes, U32).min(dim=0).values
    hi_u = torch.where(act2, lanes, 0).max(dim=0).values
    span_u = (hi_u - lo_u) & U32
    lanes_i = as_i32(lanes)
    lo_i = torch.where(act2, lanes_i, (1 << 31) - 1).min(dim=0).values
    hi_i = torch.where(act2, lanes_i, -(1 << 31)).max(dim=0).values
    span_i = (hi_i - lo_i) & U32
    return (torch.where(span_i < span_u, lo_i & U32, lo_u),
            torch.minimum(span_i, span_u))


def value_lanes32(values: torch.Tensor, type_) -> List[torch.Tensor]:
    """Bit-equality u32 lanes (int64 tensors) of an integer, temporal,
    decimal, float or bool values buffer."""
    t = type_
    v = values
    if isinstance(t, dt.BoolType):
        return [v.to(torch.int64)]
    if t.is_floating:
        if t.bits == 64:
            bits = torch.where(torch.isnan(v), _QNAN64, v.view(torch.int64))
            return split_u64(bits)
        if t.bits == 32:
            bits = v.view(torch.int32).to(torch.int64) & U32
            return [torch.where(torch.isnan(v), 0x7FC00000, bits)]
        bits = v.view(torch.int16).to(torch.int64) & 0xFFFF
        return [torch.where(torch.isnan(v), 0x7E00, bits)]
    if isinstance(t, dt.DictionaryType):
        raise NotImplementedError(f"value lanes for {t}")
    if isinstance(t, dt.DecimalType) and t.wide:
        # two limbs [lo, hi] -> the hi limb's lanes, then the lo limb's
        return split_u64(v[:, 1]) + split_u64(v[:, 0])
    if t.is_integer or t.is_temporal or isinstance(t, dt.DecimalType):
        if t.bit_width == 64:
            return split_u64(v)
        if v.dtype in SIGNED_OF:
            return [unsigned_to_int64(v)]
        return [v.to(torch.int64) & U32]
    raise NotImplementedError(f"value lanes for {t}")


def ascending_lanes32(values: torch.Tensor, type_) -> List[torch.Tensor]:
    """u32 lanes (int64 tensors) whose lexicographic order is the column's
    ascending sort order (Arrow's radix key normalization, in lanes). NaNs
    sort greatest (before nulls); -0.0 is canonicalized equal to 0.0 (ties
    keep input order through the stable sort, as Arrow's comparator has
    them). float64 lanes are the value's exact IEEE bits."""
    t = type_
    v = values
    if isinstance(t, dt.BoolType):
        return [v.to(torch.int64)]
    if t.is_floating:
        vv = torch.where(v == 0, torch.zeros_like(v), v)
        if t.bits == 64:
            bits = torch.where(torch.isnan(vv), _QNAN64,
                               vv.view(torch.int64))
            hi, lo = split_u64(bits)
            sign = (hi >> 31) != 0
            return [torch.where(sign, hi ^ U32, hi | _BIAS32),
                    torch.where(sign, lo ^ U32, lo)]
        if t.bits == 32:
            bits = vv.view(torch.int32).to(torch.int64) & U32
            bits = torch.where(torch.isnan(vv), 0x7FC00000, bits)
            return [torch.where((bits >> 31) != 0, bits ^ U32,
                                bits | _BIAS32)]
        bits = vv.view(torch.int16).to(torch.int64) & 0xFFFF
        bits = torch.where(torch.isnan(vv), 0x7E00, bits)
        return [torch.where((bits >> 15) != 0, bits ^ 0xFFFF, bits | 0x8000)]
    if isinstance(t, dt.DecimalType) and t.wide:
        # i128 order: signed hi limb (sign-biased), then the unsigned lo limb
        hi_hi, hi_lo = split_u64(v[:, 1])
        lo_hi, lo_lo = split_u64(v[:, 0])
        return [hi_hi ^ _BIAS32, hi_lo, lo_hi, lo_lo]
    if t.is_signed_integer or t.is_temporal or isinstance(t, dt.DecimalType):
        if t.bit_width == 64:
            hi, lo = split_u64(v)
            return [hi ^ _BIAS32, lo]
        return [(v.to(torch.int64) & U32) ^ _BIAS32]
    if t.is_unsigned_integer:
        if t.bit_width == 64:
            return split_u64(v)
        if v.dtype in SIGNED_OF:
            return [unsigned_to_int64(v)]
        return [v.to(torch.int64)]
    raise NotImplementedError(f"ascending lanes for {t}")
