"""Bijective 32-bit plane packing of fixed-width columns.

The counterpart of the JAX package's ``ops/planes.py``. Materialization
paths that gather several columns through the same indices (join outputs,
wide takes) pack all fixed-width columns into ONE (rows, W) matrix of
32-bit words, gather rows once, and unpack: a row gather moves W adjacent
words per index, which is what a GPU's memory system wants from a random
access.

The matrix holds the same words as the JAX package's uint32 matrix, as an
int32 tensor (torch has no shifts or gathers for uint32 on the card); view
it as uint32 to compare. The packing is exactly invertible (unlike
``ops/bits.value_lanes32``, which canonicalizes NaNs for key equality):
every storage bit round-trips, float64 through its int64 bits. Validity
bitmaps pack as bit planes, 32 columns per extra word. A dictionary column
packs as its indices; ``unpack_columns`` gives it its dictionary back.
Varlen columns do not pack: they gather through ``take_array``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core import datatype as dt
from ..core.array import Array
from .bits import as_signed_bits
from .kernel_utils import torch_dtype

__all__ = ["plane_width", "can_pack", "pack_spec", "pack_columns",
           "unpack_columns"]


def _words_hi_first(v: torch.Tensor) -> List[torch.Tensor]:
    """The 32-bit words of each row of a 64-bit-element tensor ((cap,) or
    (cap, k)), most significant word of the LAST element first (the lane
    order of ``split_u64`` per element, last element leading)."""
    cap = v.shape[0]
    w = as_signed_bits(v).contiguous().view(torch.int32).reshape(cap, -1)
    return [w[:, j] for j in range(w.shape[1] - 1, -1, -1)]


def _storage_lanes(a: Array) -> Optional[List[torch.Tensor]]:
    """Bijective 32-bit lanes (int32) of a column's storage, or None if the
    type does not plane-pack (varlen / nested)."""
    t = a.type
    v = a.values
    if plane_width(t) is None:
        return None
    if isinstance(t, dt.DictionaryType):
        return [v.to(torch.int32)]
    if isinstance(t, dt.BoolType):
        return [v.to(torch.int32)]
    if t.is_floating:
        if t.bits == 64:
            return _words_hi_first(v)
        if t.bits == 16:
            return [v.view(torch.int16).to(torch.int32) & 0xFFFF]
        return [v.view(torch.int32)]
    if isinstance(t, dt.DecimalType) and t.wide:
        # (cap, 2) [lo limb, hi limb] -> hi.hi, hi.lo, lo.hi, lo.lo
        return _words_hi_first(v)
    if t.bit_width == 64:
        return _words_hi_first(v)
    if v.dtype == torch.uint16:
        return [v.view(torch.int16).to(torch.int32) & 0xFFFF]
    # signed values sign-extend, uint8 zero-extends, uint32 keeps its bits
    return [as_signed_bits(v).to(torch.int32)]


def _storage_from_lanes(lanes: List[torch.Tensor], t: dt.DataType
                        ) -> torch.Tensor:
    """A column's storage from its lanes (columns of the matrix): a tensor
    of its own, never a strided view of the matrix."""
    dtype = torch_dtype(t)
    if isinstance(t, dt.BoolType):
        return lanes[0] != 0
    if isinstance(t, dt.DictionaryType):
        return lanes[0].to(dtype).contiguous()
    wide = isinstance(t, dt.DecimalType) and t.wide
    if wide or t.bit_width == 64:
        # back to little-endian word order, then to 64-bit elements
        w = torch.stack(lanes[::-1], dim=1).view(torch.int64)
        return w if wide else w.reshape(-1).view(dtype)
    if t.is_floating:
        if t.bits == 16:
            return lanes[0].to(torch.int16).view(torch.float16)
        return lanes[0].contiguous().view(torch.float32)
    if dtype in (torch.uint16, torch.uint32):
        signed = torch.int16 if dtype == torch.uint16 else torch.int32
        return lanes[0].to(signed).contiguous().view(dtype)
    return lanes[0].to(dtype).contiguous()


def plane_width(t: dt.DataType) -> Optional[int]:
    """Number of 32-bit lanes a column of type t packs into (None:
    cannot)."""
    if t.is_varlen or t.is_nested:
        return None
    if isinstance(t, (dt.BoolType, dt.DictionaryType)):
        return 1
    if t.is_floating:
        return 2 if t.bits == 64 else 1
    if isinstance(t, dt.DecimalType):
        return 4 if t.wide else 2
    if t.is_integer or t.is_temporal:
        return 2 if t.bit_width == 64 else 1
    return None


def can_pack(types: Sequence[dt.DataType]) -> bool:
    return all(plane_width(t) is not None for t in types)


def pack_spec(cols: Sequence[Array]) -> tuple:
    """The static spec ``pack_columns`` would produce, without packing."""
    return tuple((a.type, plane_width(a.type), a.validity is not None)
                 for a in cols)


def pack_columns(cols: Sequence[Array]) -> Tuple[torch.Tensor, tuple]:
    """Pack columns into ((cap, W) int32, spec). All columns must share one
    capacity and satisfy ``plane_width``. Validity bitmaps pack as bit
    planes appended after the value lanes (32 columns per lane)."""
    assert cols, "pack_columns needs at least one column"
    lanes: List[torch.Tensor] = []
    spec = []
    plane, bit = None, 0
    vplanes: List[torch.Tensor] = []
    for a in cols:
        ls = _storage_lanes(a)
        assert ls is not None, a.type
        spec.append((a.type, len(ls), a.validity is not None))
        lanes.extend(ls)
        if a.validity is None:
            continue
        b = a.validity.to(torch.int32) << (bit % 32)
        plane = b if plane is None else plane | b
        bit += 1
        if bit % 32 == 0:
            vplanes.append(plane)
            plane = None
    if plane is not None:
        vplanes.append(plane)
    return torch.stack(lanes + vplanes, dim=1), tuple(spec)


def unpack_columns(mat: torch.Tensor, spec: tuple, length,
                   extra_valid: Optional[torch.Tensor] = None,
                   dictionaries: Optional[Sequence] = None) -> List[Array]:
    """Inverse of ``pack_columns`` over a (rows, W) gathered matrix.
    ``extra_valid`` ANDs into every column's validity (join null
    extension); columns without a packed validity get it as their
    validity when provided. ``dictionaries``: each column's dictionary
    (None for the others)."""
    out: List[Array] = []
    j = 0
    vstart = sum(w for (_, w, _) in spec)
    bit = 0
    for i, (t, w, has_valid) in enumerate(spec):
        vals = _storage_from_lanes([mat[:, j + k] for k in range(w)], t)
        j += w
        validity = None
        if has_valid:
            validity = ((mat[:, vstart + bit // 32] >> (bit % 32)) & 1) != 0
            bit += 1
        if extra_valid is not None:
            validity = extra_valid if validity is None else \
                (validity & extra_valid)
        out.append(Array(t, vals, validity, length=length,
                         dictionary=None if dictionaries is None
                         else dictionaries[i]))
    return out
