"""Bit-lane extraction for key normalization (grouping).

The counterpart of ``value_lanes32`` in the JAX package's ``ops/bits.py``.
Lanes are u32 values held in int64 tensors (torch has no add, shift,
compare or min on uint32), so every lane value is in [0, 2^32) and int64
order equals the u32 order. Group equality is Arrow's byte equality:
-0.0 != 0.0; NaNs are canonicalized to one quiet NaN, as in the JAX
package. torch has real IEEE float64 on every device, so f64 lanes are its
exact bits.
"""

from __future__ import annotations

from typing import List

import torch

from ..core import datatype as dt

__all__ = ["U32", "split_u64", "value_lanes32"]

U32 = 0xFFFFFFFF


def split_u64(x: torch.Tensor) -> List[torch.Tensor]:
    """[hi, lo] u32 lanes (int64) of a 64-bit integer tensor (a uint64
    tensor by its bits)."""
    x = x.view(torch.int64) if x.dtype == torch.uint64 else x.to(torch.int64)
    return [(x >> 32) & U32, x & U32]


def value_lanes32(values: torch.Tensor, type_) -> List[torch.Tensor]:
    """Bit-equality u32 lanes (int64 tensors) of an integer, temporal,
    float or bool values buffer."""
    t = type_
    v = values
    if isinstance(t, dt.BoolType):
        return [v.to(torch.int64)]
    if t.is_floating:
        if t.bits == 64:
            bits = torch.where(torch.isnan(v),
                               torch.tensor(0x7FF8000000000000,
                                            device=v.device),
                               v.view(torch.int64))
            return split_u64(bits)
        if t.bits == 32:
            bits = v.view(torch.int32).to(torch.int64) & U32
            return [torch.where(torch.isnan(v), 0x7FC00000, bits)]
        bits = v.view(torch.int16).to(torch.int64) & 0xFFFF
        return [torch.where(torch.isnan(v), 0x7E00, bits)]
    if isinstance(t, (dt.DictionaryType, dt.DecimalType)):
        raise NotImplementedError(f"value lanes for {t}")
    if t.is_integer or t.is_temporal:
        if t.bit_width == 64:
            return split_u64(v)
        return [v.to(torch.int64) & U32]
    raise NotImplementedError(f"value lanes for {t}")
