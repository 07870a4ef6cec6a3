"""Selection kernels: filter / take / indices-from-mask.

Reference: ``cpp/src/arrow/compute/kernels/vector_selection*.cc``; the
counterpart of the JAX package's ``ops/selection.py``, with its two kernel
routes under their JAX names:

  * ``impl="dma"`` (``filter_batch``'s default): a fixed-width batch filters
    in ONE launch of the stream-compaction kernel
    (``cuda_kernels.filter_compact_columns``), which takes every column
    and validity as it lies and gives the selected count (the JAX
    package's ``_filter_batch_dma`` path, without its byte planes).
  * ``impl="pallas"``: take indices, then ``take_batch``.
    ``get_take_indices`` compacts each 1024-row tile of the selection with
    ``cuda_kernels.tile_compact_local`` (level 1) and stitches the tiles
    into global indices with ``cuda_kernels.tile_stitch`` (level 2, the JAX
    package's ``_pallas_take_indices``). On the card both levels are
    hand-written kernels (the stitch scatters each tile's indices straight
    to their place); on the CPU both take their plain versions, the
    stitch's being the JAX package's form: ``rows_of_positions`` and two
    gathers. ``filter_array`` and the take functions run on it too.

All paths give the same rows in the same order.

Outputs keep the input capacity; ``length`` is the number of selected rows
(a 0-d tensor on the device). Padding rows are unspecified.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch
from ..compute.registry import Kind, NullHandling, register_function
from .cuda_kernels import TILE_ROWS, filter_compact_columns, \
    tile_compact_local, tile_stitch
from .bits import as_signed_bits, gather_rows
from .kernel_utils import to_storage
from .segment import _scatter, rows_of_positions

__all__ = ["FilterOptions", "TakeOptions", "get_take_indices", "take_array",
           "filter_array", "take_batch", "filter_batch",
           "rows_of_positions"]


class FilterOptions:
    DROP = "drop"
    EMIT_NULL = "emit_null"

    def __init__(self, null_selection_behavior: str = "drop"):
        assert null_selection_behavior in (self.DROP, self.EMIT_NULL)
        self.null_selection_behavior = null_selection_behavior


class TakeOptions:
    def __init__(self, boundscheck: bool = True):
        self.boundscheck = boundscheck


def _selection_mask(mask: Array, null_selection: str, count: bool = True):
    """(selected bool (capacity,), emit_valid bool or None, out_len: the
    selected count as a 0-d int32, or None where ``count`` is False because
    the caller has it from elsewhere)."""
    mvals = mask.values.to(torch.bool)
    mvalid = mask.validity
    # no padding rows to mask off when the length is the whole capacity
    full = mask.has_static_length and len(mask) == mask.capacity
    in_range = None if full else mask.row_mask()
    if null_selection == FilterOptions.DROP or mvalid is None:
        sel = mvals if mvalid is None else (mvals & mvalid)
        emit_valid = None
    else:
        sel = (mvals & mvalid) | ~mvalid
        emit_valid = mvalid  # selected-and-null -> null output row
    if in_range is not None:
        sel = sel & in_range
    out_len = torch.sum(sel, dtype=torch.int32) if count else None
    return sel, emit_valid, out_len


def _tile_take_indices(sel: torch.Tensor, emit_valid):
    """Level 1: ``tile_compact_local`` over the selection, padded with
    unselected rows to a multiple of 1024. Level 2: per-tile counts ->
    exclusive prefix sum = each tile's start in the output, and
    ``tile_stitch`` moves every tile's local indices to their place as
    global take indices (zeros past the count, so padding stays in range).
    Returns (indices, validity or None, the selected count: the last
    start). No host read: the count stays on the device."""
    cap = sel.shape[0]
    dev = sel.device
    pad = (-cap) % TILE_ROWS
    if pad:
        sel = torch.cat([sel, torch.zeros((pad,), dtype=torch.bool,
                                          device=dev)])
    loc, counts = tile_compact_local(sel)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    # at most cap rows are selected, so cap output positions suffice
    indices = tile_stitch(loc, counts, starts, cap)
    validity = None
    if emit_valid is not None:
        live = torch.arange(cap, dtype=torch.int32, device=dev) < starts[-1]
        validity = emit_valid[indices.long()] | ~live
    return indices, validity, starts[-1]


def _scatter_take_indices(sel: torch.Tensor, emit_valid):
    """The scatter form (the JAX package's CPU default): each selected row
    goes to its rank, slot ``cap`` is the dump. The reference the tests
    hold the tile route against; no entry point takes it."""
    cap = sel.shape[0]
    dev = sel.device
    pos = torch.where(sel, torch.cumsum(sel, 0) - 1, cap)
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    indices = _scatter(cap, 0, pos, iota)
    validity = None
    if emit_valid is not None:
        validity = _scatter(cap, True, pos, emit_valid)
    return indices, validity


def get_take_indices(mask: Array,
                     null_selection: str = FilterOptions.DROP) -> Array:
    """Filter mask -> int32 take indices (length = selected count; rows
    past it hold 0), through ``tile_compact_local`` on either device.

    DROP: selected = valid & true. EMIT_NULL: null mask slots are selected
    too but yield a null index (validity=False) so takes produce null rows.
    """
    sel, emit_valid, _ = _selection_mask(mask, null_selection, count=False)
    if mask.capacity == 0:
        return Array(dt.int32, sel.to(torch.int32), emit_valid,
                     length=torch.zeros((), dtype=torch.int32,
                                        device=sel.device))
    indices, validity, out_len = _tile_take_indices(sel, emit_valid)
    return Array(dt.int32, indices, validity, length=out_len)


def _gather_validity(values: Array, idx: torch.Tensor,
                     idx_validity: Optional[torch.Tensor]):
    validity = None
    if values.validity is not None:
        validity = values.validity[idx]
    if idx_validity is not None:
        validity = idx_validity if validity is None \
            else (validity & idx_validity)
    return validity


def take_array(values: Array, indices: Array, grow: int = 1) -> Array:
    """Gather rows of a fixed-width `values` at `indices` (Arrow `take`).
    Indices (any integer type; uint64 as ``sort_indices`` gives them) must
    be in [0, values.capacity), padding rows included. ``grow`` sizes the
    byte pool of a varlen result in the JAX package; a fixed-width take
    does not read it."""
    if values.type.is_varlen or values.type.is_nested or \
            isinstance(values.type, dt.DictionaryType):
        raise NotImplementedError(
            f"take of {values.type} (ROADMAP queue item A3)")
    idx = as_signed_bits(indices.values).long()
    return Array(values.type, gather_rows(values.values, idx),
                 _gather_validity(values, idx, indices.validity),
                 length=indices.length)


def take_batch(b: Batch, indices: Array) -> Batch:
    arrays = [take_array(b.column(i), indices) for i in range(b.num_columns)]
    return Batch(b.schema, arrays, indices.length, b.index)


def filter_array(values: Array, mask: Array,
                 options: Optional[FilterOptions] = None) -> Array:
    opts = options or FilterOptions()
    return take_array(values,
                      get_take_indices(mask, opts.null_selection_behavior))


def _filter_batch_columns(b: Batch, mask: Array,
                          null_selection: str) -> Batch:
    """Single-pass compaction (JAX ``_filter_batch_dma``): ONE kernel
    launch compacts every column's values (bool as bytes) and validity
    (where there is one or nulls are emitted) as they lie, and gives the
    selected count; no byte planes are packed or unpacked."""
    sel, emit_valid, _ = _selection_mask(mask, null_selection, count=False)
    if b.capacity == 0:
        return b.with_length(torch.zeros((), dtype=torch.int32,
                                         device=sel.device))
    columns, has_validity = [], []
    for a in b.arrays:
        v = a.values
        columns.append(v.view(torch.uint8) if v.dtype == torch.bool else v)
        validity = a.validity
        if emit_valid is not None:
            validity = emit_valid if validity is None \
                else validity & emit_valid
        if validity is not None:
            columns.append(validity.view(torch.uint8))
        has_validity.append(validity is not None)
    outs, out_len = filter_compact_columns(sel, columns)
    outs = iter(outs)
    arrays = []
    for a, valid in zip(b.arrays, has_validity):
        values = next(outs)
        if a.values.dtype == torch.bool:
            values = values.view(torch.bool)
        validity = next(outs).view(torch.bool) if valid else None
        arrays.append(Array(a.type, values, validity, length=out_len))
    return Batch(b.schema, arrays, out_len, b.index)


def filter_batch(b: Batch, mask: Array,
                 options: Optional[FilterOptions] = None,
                 impl: str = "dma") -> Batch:
    """Rows of ``b`` where ``mask`` selects. ``impl`` names the route as the
    JAX package does: "dma" compacts the columns in one kernel launch,
    "pallas" builds take indices and gathers every column."""
    opts = options or FilterOptions()
    if impl == "pallas":
        return take_batch(b, get_take_indices(
            mask, opts.null_selection_behavior))
    if impl != "dma":
        raise ValueError(f"filter_batch impl {impl!r}: 'dma' or 'pallas'")
    for i in range(b.num_columns):
        t = b.column(i).type
        if t.is_varlen or t.is_nested or isinstance(
                t, (dt.DictionaryType, dt.FixedSizeBinaryType)) or \
                (isinstance(t, dt.DecimalType) and t.wide):
            raise NotImplementedError(f"filter_batch of {t}")
    return _filter_batch_columns(b, mask, opts.null_selection_behavior)


# ---- registry entries ---------------------------------------------------------

@register_function("filter", Kind.VECTOR, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=FilterOptions)
def _filter(args, options):
    values, mask = args
    if isinstance(values, Batch):
        return filter_batch(values, mask, options)
    return filter_array(values, mask, options)


@register_function("take", Kind.VECTOR, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=TakeOptions)
def _take(args, options):
    values, indices = args
    if isinstance(values, Batch):
        return take_batch(values, indices)
    return take_array(values, indices)


@register_function("array_take_indices_from_mask", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=FilterOptions)
def _indices_nonzero(args, options):
    (mask,) = args
    opts = options or FilterOptions()
    return get_take_indices(mask, opts.null_selection_behavior)


@register_function("array_filter", Kind.VECTOR, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=FilterOptions)
def _array_filter(args, options):
    values, mask = args
    return filter_array(values, mask, options)


@register_function("array_take", Kind.VECTOR, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=TakeOptions)
def _array_take(args, options):
    values, indices = args
    return take_array(values, indices)


@register_function("drop_null", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _drop_null(args, options):
    """Remove null rows (vector_selection.cc DropNull)."""
    a = args[0]
    if isinstance(a, Batch):
        ok = torch.ones((a.capacity,), dtype=torch.bool, device=a.device)
        for i in range(a.num_columns):
            c = a.column(i)
            if c.validity is not None:
                ok = ok & c.validity
        return filter_batch(a, Array(dt.bool_, ok, None, length=a.length))
    if a.validity is None:
        return a
    return filter_array(a, Array(dt.bool_, a.validity, None,
                                 length=a.length))


@register_function("inverse_permutation", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _inverse_permutation(args, options):
    """vector_swizzle.cc InversePermutation: out[perm[i]] = i; positions
    not hit are null."""
    a = args[0]
    cap = a.capacity
    idx = as_signed_bits(a.values).to(torch.int64)
    pos = torch.where(a.present_mask(), idx.clamp(0, max(cap - 1, 0)), cap)
    iota = torch.arange(cap, dtype=torch.int32, device=a.device)
    out = _scatter(cap, 0, pos, iota)
    hit = _scatter(cap, False, pos, torch.ones_like(iota, dtype=torch.bool))
    out_t = a.type if a.type.is_integer else dt.int32
    return Array(out_t, to_storage(out, out_t), hit, length=a.length)
