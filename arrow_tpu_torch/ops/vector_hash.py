"""Vector hash kernels: unique / value_counts / dictionary_encode /
dictionary_decode; the counterpart of the JAX package's
``ops/vector_hash.py``.

Reference: ``cpp/src/arrow/compute/kernels/vector_hash.cc`` (UniqueAction
:65, ValueCountsAction :101, DictEncodeAction :173 over ``MemoTable``):
per-row memo-table inserts. Here, as in the JAX package, distinct values
come from one sort (``ops/distinct.sort_distinct``): rows normalize to u32
key lanes (raw-bit equality; a validity lane where nulls count), one
lexicographic sort groups equal keys into runs, and ranking the runs by
their first row gives Arrow's order of first appearance. There is no cap
on the number of distinct values.

String columns key on their content lanes (``hashing.varlen_content_lanes``);
dictionary columns on their indices, or with nulls counted on the content
of their values (``grouper.group_key_lanes``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch
from ..core.schema import Field, Schema
from ..compute.registry import Kind, NullHandling, register_function
from .bits import U32, value_lanes32
from .distinct import sort_distinct
from .grouper import group_key_lanes
from .kernel_utils import torch_dtype
from .selection import take_array

__all__ = ["unique_array", "value_counts_array", "dictionary_encode_array",
           "dictionary_decode_array", "sort_distinct"]

_I32MAX = (1 << 31) - 1


def _value_lanes(a: Array):
    """Bit-equality u32 lanes (int64) of a column's values, nulls not
    distinguished: a dictionary column's indices, a decimal's limbs."""
    t, v = a.type, a.values
    if isinstance(t, dt.DictionaryType):
        return [v.to(torch.int64) & U32]
    return value_lanes32(v, t)


def _key_lanes(a: Array, include_validity: bool) -> torch.Tensor:
    """(capacity, L) int64 u32-lane matrix for equality grouping."""
    if a.type.is_varlen:
        from .hashing import varlen_content_lanes
        lanes = varlen_content_lanes(a)
        if include_validity and a.validity is not None:
            ok = a.validity
            lanes = [ok.to(torch.int64)] + [torch.where(ok, x, 0)
                                             for x in lanes]
        return torch.stack(lanes, dim=1)
    if include_validity:
        return group_key_lanes([a])
    # nulls are not keyed: the caller leaves them inactive
    return torch.stack(_value_lanes(a), dim=1)


def _distinct(a: Array, include_nulls: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes per row, first row of each distinct value, their number)."""
    active = a.row_mask() if include_nulls else a.present_mask()
    return sort_distinct(_key_lanes(a, include_nulls), active)


def _first_rows(unique_rows: torch.Tensor, n) -> Array:
    return Array(dt.int32, torch.where(unique_rows == _I32MAX, 0,
                                       unique_rows), length=n)


def unique_array(a: Array) -> Array:
    """Distinct values in order of first appearance, null once
    (``pa.compute.unique``)."""
    _, unique_rows, n = _distinct(a, include_nulls=True)
    return take_array(a, _first_rows(unique_rows, n))


def value_counts_array(a: Array) -> Batch:
    """Distinct values and their counts, in order of first appearance
    (``pa.compute.value_counts``); a 2-column Batch (values, counts) in
    place of Arrow's StructArray."""
    codes, unique_rows, n = _distinct(a, include_nulls=True)
    cap = codes.shape[0]
    counts = torch.zeros((cap + 1,), dtype=torch.int64, device=codes.device) \
        .index_add_(0, torch.where(codes >= 0, codes, cap).long(),
                    torch.ones_like(codes, dtype=torch.int64))[:cap]
    values = take_array(a, _first_rows(unique_rows, n))
    schema = Schema((Field("values", a.type, True),
                     Field("counts", dt.int64, False)))
    return Batch(schema, [values, Array(dt.int64, counts, None, length=n)],
                 n)


def dictionary_encode_array(a: Array, index_type: dt.DataType = dt.int32
                            ) -> Array:
    """Dictionary-encode (``pa.compute.dictionary_encode``): nulls get a
    null index (Arrow's NullEncodingBehavior::MASK); the dictionary holds
    the non-null distinct values in order of first appearance."""
    if isinstance(a.type, dt.DictionaryType):
        return a
    codes, unique_rows, n = _distinct(a, include_nulls=False)
    dictionary = take_array(a, _first_rows(unique_rows, n)) \
        .with_validity(None)
    out_codes = torch.clamp(codes, min=0).to(torch_dtype(index_type))
    return Array(dt.dictionary(index_type, a.type), out_codes,
                 a.present_mask(), dictionary=dictionary, length=a.length)


def dictionary_decode_array(a: Array) -> Array:
    """The values a dictionary column's indices name (a plain column of
    the dictionary's type); other columns as they are."""
    if not isinstance(a.type, dt.DictionaryType):
        return a
    return take_array(a.dictionary, Array(dt.int32, a.values.to(torch.int32),
                                          a.validity, length=a.length))


# ---- registration ------------------------------------------------------------

@register_function("unique", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _unique(args, options):
    return unique_array(args[0])


@register_function("value_counts", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _value_counts(args, options):
    return value_counts_array(args[0])


@register_function("dictionary_encode", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _dictionary_encode(args, options):
    return dictionary_encode_array(args[0])


@register_function("dictionary_decode", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _dictionary_decode(args, options):
    return dictionary_decode_array(args[0])
