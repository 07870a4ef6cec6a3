"""String kernels: exact comparison of varlen columns.

The counterpart of the comparison in the JAX package's ``ops/strings.py``
(``compare_varlen`` and its helpers); the rest of that module (case, trim,
pad, slice, match, replace) is ROADMAP queue item A7.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.scalar import Scalar
from .segment import rows_of_positions

__all__ = ["compare_varlen"]

_FLIP = {"less": "greater", "greater": "less", "less_equal": "greater_equal",
         "greater_equal": "less_equal"}


def _pat_bytes(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("utf-8")
    return np.frombuffer(s, dtype=np.uint8)


def _lens(a: Array) -> torch.Tensor:
    return a.offsets[1:] - a.offsets[:-1]


def _decode(a: Array) -> Array:
    """A dictionary column of strings as the plain varlen column of its
    rows' values."""
    from .selection import take_array
    return take_array(a.dictionary, Array(dt.int32, a.values, None,
                                          length=a.length),
                      grow=-(-max(a.capacity, 1) //
                             max(a.dictionary.capacity, 1)))


def _result(op: str, cmp: torch.Tensor) -> torch.Tensor:
    return {"equal": cmp == 0, "not_equal": cmp != 0, "less": cmp < 0,
            "less_equal": cmp <= 0, "greater": cmp > 0,
            "greater_equal": cmp >= 0}[op]


def _compare_scalar(a: Array, value) -> torch.Tensor:
    """(capacity,) int32: -1 / 0 / 1 as each row of ``a`` orders against
    the scalar's bytes: the first differing byte decides, else the
    length."""
    pat = _pat_bytes(value if value is not None else "")
    lens = _lens(a)
    dev = a.device
    bcap = a.values.shape[0]
    pool = a.values if bcap else torch.zeros((1,), dtype=torch.uint8,
                                             device=dev)
    starts = a.offsets[:-1].long()
    cmp = torch.zeros((a.capacity,), dtype=torch.int32, device=dev)
    decided = torch.zeros((a.capacity,), dtype=torch.bool, device=dev)
    for k, pb in enumerate(pat.tolist()):
        byte = pool[(starts + k).clamp_(0, max(bcap - 1, 0))].to(torch.int32)
        have = lens > k
        # a row that runs out first is a prefix of the scalar: less
        d = torch.where(have, torch.sign(byte - pb), -1).to(torch.int32)
        newly = ~decided & (d != 0)
        cmp = torch.where(newly, d, cmp)
        decided |= newly
    # the first len(pat) bytes are equal: a longer row is greater
    return torch.where(decided, cmp, (lens > len(pat)).to(torch.int32))


def _compare_arrays(a: Array, b: Array) -> torch.Tensor:
    """(capacity,) int32 row-wise order of two varlen columns of one
    capacity: an aligned walk over ``a``'s pool (byte j of row r against
    ``b``'s byte ``b.off[r] + j - a.off[r]``), the first differing position
    per row by one index-min, else the lengths. Every per-byte array is
    int32 or narrower and is freed once used."""
    cap = a.capacity
    dev = a.device
    lens_a, lens_b = _lens(a), _lens(b)
    len_cmp = torch.sign(lens_a - lens_b).to(torch.int32)
    bcap_a, bcap_b = a.values.shape[0], b.values.shape[0]
    if bcap_a == 0 or bcap_b == 0:
        return len_cmp
    rows = rows_of_positions(a.offsets, bcap_a).clamp_(0, max(cap - 1, 0))
    pos = torch.arange(bcap_a, dtype=torch.int32, device=dev)
    pos -= a.offsets.index_select(0, rows)          # byte j of its row
    src = b.offsets.index_select(0, rows)
    src += pos
    differ = a.values != b.values.index_select(0, src.clamp_(0, bcap_b - 1))
    del src
    # bytes past either row's end, or outside every row, differ in neither
    differ &= pos < torch.minimum(lens_a, lens_b).index_select(0, rows)
    differ &= pos >= 0
    rows.masked_fill_(~differ, cap)
    del differ
    big = torch.iinfo(torch.int32).max
    first = torch.full((cap + 1,), big, dtype=torch.int32, device=dev)
    first.index_reduce_(0, rows, pos, "amin")
    del rows, pos
    first = first[:cap]
    decided = first < big
    at = torch.where(decided, first, 0)
    byte_a = a.values[(a.offsets[:-1] + at).clamp_(0, bcap_a - 1).long()]
    byte_b = b.values[(b.offsets[:-1] + at).clamp_(0, bcap_b - 1).long()]
    d = torch.sign(byte_a.to(torch.int32) - byte_b.to(torch.int32))
    return torch.where(decided, d.to(torch.int32), len_cmp)


def compare_varlen(op: str, a, b) -> torch.Tensor:
    """Exact lexicographic (unsigned) byte comparison: Array vs Array (one
    capacity) or Array vs Scalar, either side a dictionary of strings.
    Returns (capacity,) bool values; validity is the caller's."""
    if isinstance(a, Scalar) and isinstance(b, Array):
        return compare_varlen(_FLIP.get(op, op), b, a)
    if isinstance(b, Scalar):
        if isinstance(a.type, dt.DictionaryType):
            # through the dictionary: compare its values, gather by index
            inner = compare_varlen(op, a.dictionary, b)
            return inner[a.values.long().clamp(
                0, max(a.dictionary.capacity - 1, 0))]
        return _result(op, _compare_scalar(a, b.value))
    if isinstance(a.type, dt.DictionaryType):
        a = _decode(a)
    if isinstance(b.type, dt.DictionaryType):
        b = _decode(b)
    return _result(op, _compare_arrays(a, b))
