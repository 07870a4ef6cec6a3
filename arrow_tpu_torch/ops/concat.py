"""Batch concatenation (pipeline-breaker accumulation).

Used by order_by / aggregate / join build sides to fuse a stream of batches
into one device batch; the counterpart of the JAX package's
``ops/concat.py``. Sequential writes: batch i + 1's region overwrites batch
i's trailing padding, so only the final tail is padding. A varlen column
writes its rebased offsets and its pool the same way (the pools' used
bytes end to end); dictionary columns share one dictionary, the first
real one (neither package unifies dictionaries across sources or
batches: ROADMAP C24).

Lengths may be host ints or 0-d tensors on the arrays' device. With host
ints every write is a slice assignment and the result's length is a host
int. As soon as one length is a tensor, the running offset is one too, the
writes go through ``index_copy_`` at ``offset + arange(capacity)`` (no host
read) and the result's length is a 0-d int32 tensor.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch
from .bits import as_signed_bits

__all__ = ["concat_batches", "concat_arrays"]


def _write_values(dst: torch.Tensor, src: torch.Tensor, offset) -> None:
    """dst[offset : offset + len(src)] = src, in place. The caller sizes
    ``dst`` so that the region is in range."""
    if isinstance(offset, torch.Tensor):
        idx = offset + torch.arange(src.shape[0], device=src.device)
        as_signed_bits(dst).index_copy_(0, idx, as_signed_bits(src))
    else:
        dst[offset:offset + src.shape[0]] = src


def _advance(off, n, dev):
    """``off + n``: a host int while both are, else a 0-d int32 tensor."""
    if isinstance(n, torch.Tensor) or isinstance(off, torch.Tensor):
        return (off + torch.as_tensor(n, device=dev)).to(torch.int32)
    return off + int(n)


def _concat_offsets(arrays: Sequence[Array], cap: int, any_valid: bool
                    ) -> tuple:
    """The offsets (and validity) of a concatenation of varlen or list
    columns, each chunk's rebased by the items (bytes or child rows) before
    it. Returns (offsets, validity or None, rows, each chunk's first
    item)."""
    dev = arrays[0].device
    out_off = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
    out_valid = torch.zeros((cap,), dtype=torch.bool, device=dev) \
        if any_valid else None
    row_off, item_off, firsts = 0, 0, []
    for a in arrays:
        n = a.length
        used = a.offsets[n]
        # rebased offsets of this chunk (its padding rows: its end)
        _write_values(out_off, torch.minimum(a.offsets, used) + item_off,
                      row_off)
        firsts.append(item_off)
        if any_valid:
            _write_values(out_valid, a.validity_or_true(), row_off)
        row_off = _advance(row_off, n, dev)
        item_off = (used + item_off).to(torch.int32)
    # offsets past the last row: the total item count
    idx = torch.arange(cap + 1, device=dev)
    return (torch.where(idx > row_off, item_off, out_off), out_valid,
            row_off, firsts)


def _concat_varlen(arrays: Sequence[Array], cap: int, any_valid: bool
                   ) -> Array:
    out_off, out_valid, n, firsts = _concat_offsets(arrays, cap, any_valid)
    out_bytes = torch.zeros((sum(a.values.shape[0] for a in arrays),),
                            dtype=torch.uint8, device=arrays[0].device)
    for a, at in zip(arrays, firsts):
        _write_values(out_bytes, a.values, at)
    return Array(arrays[0].type, out_bytes, out_valid, length=n,
                 offsets=out_off)


def _concat_nested(arrays: Sequence[Array], cap: int, any_valid: bool
                   ) -> Array:
    """List (fixed-size list, map) columns: offsets rebased by the child
    rows before each chunk, the children's used rows concatenated. Struct
    columns: the children concatenated row for row."""
    t = arrays[0].type
    dev = arrays[0].device
    if isinstance(t, dt.ListType):
        child = concat_arrays([a.dictionary.with_length(a.offsets[a.length])
                               for a in arrays])
        out_off, out_valid, n, _ = _concat_offsets(arrays, cap, any_valid)
        return Array(t, arrays[0].values, out_valid, length=n,
                     offsets=out_off, dictionary=child)
    if isinstance(t, dt.StructType):
        out_valid = None
        if any_valid:
            out_valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
            off = 0
            for a in arrays:
                _write_values(out_valid, a.validity_or_true(), off)
                off = _advance(off, a.length, dev)
        children = tuple(
            concat_arrays([a.children[j].with_length(a.length)
                           for a in arrays], total_capacity=cap)
            for j in range(len(t.fields)))
        return Array(t, torch.zeros((cap,), dtype=torch.uint8, device=dev),
                     out_valid, length=children[0].length
                     if children else sum(int(a.length) for a in arrays),
                     children=children)
    raise NotImplementedError(f"concat of {t} columns")


def _first_dictionary(arrays: Sequence[Array]) -> Optional[Array]:
    """The first real dictionary (a placeholder batch holds an empty
    one)."""
    for a in arrays:
        d = a.dictionary
        if d is None or d.capacity == 0 or \
                (d.has_static_length and len(d) == 0):
            continue
        return d
    return arrays[0].dictionary


def concat_arrays(arrays: Sequence[Array],
                  total_capacity: Optional[int] = None) -> Array:
    assert arrays, "concat of zero arrays"
    t = arrays[0].type
    any_valid = any(a.validity is not None for a in arrays)
    dev = arrays[0].device
    cap = total_capacity or sum(a.capacity for a in arrays)
    if t.is_nested:
        return _concat_nested(arrays, cap, any_valid)
    if t.is_varlen:
        return _concat_varlen(arrays, cap, any_valid)
    first = arrays[0].values
    out_vals = torch.zeros((cap,) + tuple(first.shape[1:]),
                           dtype=first.dtype, device=dev)
    out_valid = torch.zeros((cap,), dtype=torch.bool, device=dev) \
        if any_valid else None
    off = 0
    for a in arrays:
        _write_values(out_vals, a.values, off)
        if any_valid:
            _write_values(out_valid, a.validity_or_true(), off)
        off = _advance(off, a.length, dev)
    dictionary = _first_dictionary(arrays) \
        if isinstance(t, dt.DictionaryType) else None
    return Array(t, out_vals, out_valid, length=off, dictionary=dictionary)


def concat_batches(batches: List[Batch]) -> Batch:
    assert batches, "concat of zero batches"
    if len(batches) == 1:
        return batches[0]
    schema = batches[0].schema
    cap = sum(b.capacity for b in batches)
    arrays = [concat_arrays([b.column(i) for b in batches],
                            total_capacity=cap)
              for i in range(len(schema))]
    return Batch(schema, arrays, arrays[0].length if arrays else 0)
