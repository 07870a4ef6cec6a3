"""Run-end encode / decode and ``random``; the counterpart of the JAX
package's ``ops/ree.py``.

Reference: ``vector_run_end_encode.cc`` / ``vector_run_end_decode.cc``
(the RunEndEncoded layout) and ``scalar_random.cc``.

A run-end-encoded Array keeps its run values in ``values``, its run ends
in ``offsets[1:]`` (``offsets[0]`` is 0; ends past the run count repeat
the row count) and its runs' validity in ``validity``. The encode marks
each row that ends a run (the next row differs in value or validity, or
the row is the last) and takes their indices with ``get_take_indices``:
``tile_compact_local`` and ``tile_stitch`` on the card. Null rows whose
value slots differ are separate runs, as pyarrow has them. The decode maps each output row
to its run with one ``searchsorted``; its output size is one host read of
the row count unless the caller gives ``out_capacity``.

``random`` draws from a ``torch.Generator`` on the options' device (the
card unless given): uniform float64 in [0, 1), the same values for one
initializer on one device. The JAX package draws from ``jax.random``; the
values of the two packages, and of the CPU and the card, differ.
"""

from __future__ import annotations

import os

import torch

from ..core import datatype as dt
from ..core.array import Array, resolve_device, row_mask
from ..compute.registry import Kind, NullHandling, register_function
from .bits import as_signed_bits, gather_rows
from .selection import get_take_indices

__all__ = ["RandomOptions", "run_end_encode_array", "run_end_decode_array"]


class RandomOptions:
    def __init__(self, length: int = 0, initializer="system", device=None):
        self.length = length
        self.initializer = initializer
        self.device = device


def run_end_encode_array(a: Array,
                         run_end_type: dt.DataType = dt.int32) -> Array:
    """Collapse runs of equal rows (value and validity)."""
    if a.type.is_varlen or a.type.is_nested:
        raise NotImplementedError("run_end_encode on nested/varlen")
    cap = a.capacity
    dev = a.device
    v = as_signed_bits(a.values)
    valid = a.validity_or_true()
    same = (v[1:] == v[:-1]) & (valid[1:] == valid[:-1])
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    ln = a.length
    next_differs = torch.cat([~same, torch.ones((1,), dtype=torch.bool,
                                                 device=dev)])
    is_end = a.row_mask() & (next_differs | (idx == ln - 1))
    ends = get_take_indices(Array(dt.bool_, is_end, None, length=ln))
    nruns = ends.length
    at = ends.values.long()
    offsets = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.where(row_mask(cap, nruns, dev), ends.values + 1,
                    torch.as_tensor(ln, dtype=torch.int32, device=dev))])
    return Array(dt.run_end_encoded(run_end_type, a.type),
                 gather_rows(a.values, at),
                 valid[at] if a.validity is not None else None,
                 length=nruns, offsets=offsets.to(torch.int32))


def run_end_decode_array(ree: Array, out_capacity=None) -> Array:
    """Expand the runs back to rows. ``out_capacity`` is the decoded
    capacity; without it, one host read of the row count sizes it."""
    assert isinstance(ree.type, dt.RunEndEncodedType)
    dev = ree.device
    run_ends = ree.offsets[1:]
    n = torch.as_tensor(ree.length, device=dev)
    nrows = torch.where(n > 0, run_ends[(n - 1).clamp(min=0).long()], 0)
    out_cap = out_capacity
    if out_cap is None:
        nrows = int(nrows)
        out_cap = max(nrows, 1)
    pos = torch.arange(out_cap, dtype=run_ends.dtype, device=dev)
    r = torch.searchsorted(run_ends.contiguous(), pos, right=True)
    r = r.clamp_(0, max(ree.capacity - 1, 0))
    return Array(ree.type.value_type, gather_rows(ree.values, r),
                 None if ree.validity is None else ree.validity[r],
                 length=nrows)


@register_function("run_end_encode", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _run_end_encode(args, options):
    return run_end_encode_array(args[0])


@register_function("run_end_decode", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _run_end_decode(args, options):
    return run_end_decode_array(args[0])


@register_function("random", Kind.VECTOR, 0,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=RandomOptions)
def _random(args, options):
    if options is None or options.length <= 0:
        raise ValueError("random requires RandomOptions(length=...)")
    init = options.initializer
    seed = int.from_bytes(os.urandom(4), "little") if init == "system" \
        else int(init)
    dev = resolve_device(getattr(options, "device", None))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vals = torch.rand((options.length,), dtype=torch.float64, device=dev,
                      generator=gen)
    return Array(dt.float64, vals, None, length=options.length)
