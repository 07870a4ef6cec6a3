"""Batch concatenation (pipeline-breaker accumulation).

Used by order_by / aggregate / join build sides to fuse a stream of batches
into one device batch; the counterpart of the JAX package's
``ops/concat.py`` for fixed-width columns. Sequential writes: batch i + 1's
region overwrites batch i's trailing padding, so only the final tail is
padding.

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


def concat_arrays(arrays: Sequence[Array],
                  total_capacity: Optional[int] = None) -> Array:
    assert arrays, "concat of zero arrays"
    t = arrays[0].type
    if t.is_varlen or isinstance(t, dt.DictionaryType):
        raise NotImplementedError(
            f"concat of {t} columns (ROADMAP queue item A3: varlen and "
            "dictionary columns)")
    any_valid = any(a.validity is not None for a in arrays)
    dev = arrays[0].device
    cap = total_capacity or sum(a.capacity for a in arrays)
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
        n = a.length
        if isinstance(n, torch.Tensor) or isinstance(off, torch.Tensor):
            off = (off + torch.as_tensor(n, device=dev)).to(torch.int32)
        else:
            off = off + int(n)
    return Array(t, out_vals, out_valid, length=off)


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
