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

Dictionary columns move their int32 indices like any column and keep their
dictionary. Varlen (string / binary) columns move their row lengths like
any column; their byte pools are the new part:

  * a take (``_take_varlen``) gathers every output byte from its source:
    new offsets from the gathered lengths, each output byte's row by
    ``rows_of_positions`` over them;
  * the one-launch filter compacts each pool by a second launch of the
    same kernel over the pool as a u8 column, under a per-byte selection
    built from the row selection with one scatter at the row heads and a
    running sum (``_byte_selection``; the JAX package left-packs the pool
    with a stable 1-bit sort instead). On an NVIDIA H100 80GB HBM3 (700 W)
    this took 19.7 ms for a 1.8e9-byte pool against 81.1 ms for the
    take's gather from the compacted row starts (``PERF.md``).

Nested columns, as the JAX package takes them: a list (map, fixed-size
list) takes its child at the rows ``source_positions`` maps from the new
offsets (``_take_list``, ``_take_varlen``'s two phases over child rows); a
struct takes its children; a dense union gathers its codes and value
offsets, a sparse one takes its children; a run-end-encoded column is
decoded, taken and encoded again. ``filter_batch`` compacts a batch's flat
and varlen columns in its one launch and takes its nested columns at ONE
set of take indices (``_filter_batch_mixed``).

Outputs keep the input capacity; ``length`` is the number of selected rows
(a 0-d tensor on the device). Padding rows are unspecified.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import datatype as dt
from ..core.array import Array, row_mask
from ..core.batch import Batch
from ..core.schema import Schema
from ..compute.registry import Kind, NullHandling, register_function
from .cuda_kernels import TILE_ROWS, filter_compact_columns, \
    tile_compact_local, tile_stitch
from .bits import as_signed_bits, gather_rows
from .kernel_utils import to_storage
from .segment import _scatter, rows_of_positions

__all__ = ["FilterOptions", "TakeOptions", "get_take_indices", "take_array",
           "filter_array", "take_batch", "filter_batch",
           "rows_of_positions", "source_positions"]


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


def take_array(values: Array, indices: Array) -> Array:
    """Gather rows of ``values`` at ``indices`` (Arrow ``take``). Indices
    (any integer type; uint64 as ``sort_indices`` gives them) must be in
    [0, values.capacity), padding rows included.

    A varlen result's byte pool (a list's child) holds the rows' gathered
    total, one host read, so a take whose indices repeat rows (join
    fanout) fits where the JAX package's pool of ``grow`` times the
    input's overflows. The pool is at most 2^31 - 1 bytes (int32
    offsets): a take past it raises. ``take_arrays`` reads the totals of
    several columns at once."""
    return take_arrays([values], indices)[0]


def take_arrays(columns: Sequence[Array], indices: Array) -> list:
    """``take_array`` of each column at the same ``indices``, with ONE
    host read of the byte totals of all the flat varlen columns."""
    idx = as_signed_bits(indices.values).long()
    varlen = {i: _gathered_offsets(c.offsets, idx, indices)
              for i, c in enumerate(columns) if c.type.is_varlen}
    totals = dict(zip(varlen, torch.stack(
        [total for _, _, total in varlen.values()]).tolist())) \
        if varlen else {}
    return [_take_varlen(c, idx, indices, *varlen[i][:2], totals[i])
            if i in varlen else _take_other(c, idx, indices)
            for i, c in enumerate(columns)]


def _take_other(values: Array, idx: torch.Tensor, indices: Array) -> Array:
    """``take_array`` of a column that is not flat varlen."""
    t = values.type
    if isinstance(t, dt.ListType):
        return _take_list(values, idx, indices)
    if isinstance(t, dt.StructType):
        return Array(t, values.values[idx],
                     _gather_validity(values, idx, indices.validity),
                     length=indices.length,
                     children=tuple(take_arrays(values.children, indices)))
    if isinstance(t, dt.UnionType):
        # a dense union gathers its codes and value offsets and keeps its
        # children; a sparse one takes its children row for row
        codes = values.values[idx]
        if t.mode == "dense":
            off = torch.zeros((idx.shape[0] + 1,), dtype=torch.int32,
                              device=idx.device)
            off[:-1] = values.offsets[:-1][idx]
            return Array(t, codes, None, length=indices.length,
                         offsets=off, children=values.children)
        return Array(t, codes, None, length=indices.length,
                     children=tuple(take_arrays(values.children, indices)))
    if isinstance(t, dt.RunEndEncodedType):
        # decode, take, encode again: the column keeps its type
        from .ree import run_end_decode_array, run_end_encode_array
        return run_end_encode_array(
            take_array(run_end_decode_array(values), indices),
            run_end_type=t.run_end_type)
    return Array(t, gather_rows(values.values, idx),
                 _gather_validity(values, idx, indices.validity),
                 length=indices.length, dictionary=values.dictionary)


_MAX_POOL = (1 << 31) - 1


def _gathered_offsets(off: torch.Tensor, idx: torch.Tensor, indices: Array,
                      fixed: bool = False):
    """(starts, new_off, total): each index row's source start, the
    prefix sum of the gathered row lengths and their int64 sum (past
    2^31 - 1 the int32 offsets wrap). Null and padding index rows take
    none, except in a fixed-size list (``fixed``), whose every row keeps
    its k."""
    ok = row_mask(idx.shape[0], indices.length, off.device)
    if indices.validity is not None and not fixed:
        ok = ok & indices.validity
    starts = off[idx]
    lens = torch.where(ok, off[idx + 1] - starts, 0)
    return starts, torch.cat([lens.new_zeros((1,)),
                              torch.cumsum(lens, 0, dtype=torch.int32)]), \
        lens.sum(dtype=torch.int64)


def _take_list(values: Array, idx: torch.Tensor, indices: Array) -> Array:
    """list<T> gather, ``_take_varlen``'s two phases over child rows: new
    offsets from the gathered lengths, then every output child row maps to
    its list row (``rows_of_positions``) and from there to its source
    child row, and the child is taken there. The child holds the gathered
    total of rows (one host read)."""
    t = values.type
    child = values.dictionary
    starts, new_off, total = _gathered_offsets(
        values.offsets, idx, indices, isinstance(t, dt.FixedSizeListType))
    ccap = max(int(total), 1)
    src = source_positions(new_off, starts, ccap, child.capacity)
    new_child = take_array(child, Array(dt.int32, src, None,
                                        length=new_off[-1]))
    return Array(t, values.values, _gather_validity(values, idx,
                                                    indices.validity),
                 length=indices.length, offsets=new_off,
                 dictionary=new_child)


def _take_varlen(values: Array, idx: torch.Tensor, indices: Array,
                 starts: torch.Tensor, new_off: torch.Tensor,
                 total: int) -> Array:
    """Varlen gather in two phases (the JAX package's): the gathered row
    lengths' prefix sum is the new offsets (``_gathered_offsets``), then
    every output byte maps to its row (``rows_of_positions``) and from
    there to its source byte. ``total`` (the lengths' sum, read on the
    host) sizes the pool."""
    if total > _MAX_POOL:
        raise ValueError(f"take of {values.type}: the rows span {total} "
                         f"bytes, past the pool's limit of {_MAX_POOL}")
    pool = _gather_bytes(values.values, starts, new_off, max(total, 1))
    return Array(values.type, pool,
                 _gather_validity(values, idx, indices.validity),
                 length=indices.length, offsets=new_off)


def source_positions(new_off: torch.Tensor, starts: torch.Tensor,
                     out_cap: int, src_cap: int, step: int = 1
                     ) -> torch.Tensor:
    """(out_cap,) int32: output position p of row r (``new_off[r] <= p <
    new_off[r + 1]``) reads source position ``starts[r] + (p - new_off[r])
    * step``, clamped into [0, src_cap). Each output position finds its
    row by ``rows_of_positions``; every per-position intermediate is
    int32."""
    n = starts.shape[0]
    src = torch.arange(out_cap, dtype=torch.int32, device=new_off.device)
    if n == 0:
        return src.zero_()
    r = rows_of_positions(new_off, out_cap).clamp_(0, n - 1)
    if step == 1:
        src += (starts.to(torch.int32) - new_off[:-1]).index_select(0, r)
    else:
        src = starts.to(torch.int32).index_select(0, r) + \
            (src - new_off.index_select(0, r)) * step
    return src.clamp_(0, max(src_cap, 1) - 1)


def _gather_bytes(pool: torch.Tensor, starts: torch.Tensor,
                  new_off: torch.Tensor, bcap: int) -> torch.Tensor:
    """(bcap,) u8: output byte p of row r (``new_off[r] <= p <
    new_off[r + 1]``) is ``pool[starts[r] + p - new_off[r]]``; bytes past
    ``new_off[-1]`` are 0."""
    if pool.shape[0] == 0 or starts.shape[0] == 0:
        return torch.zeros((bcap,), dtype=torch.uint8, device=pool.device)
    live = torch.arange(bcap, dtype=torch.int32, device=pool.device) < \
        new_off[-1]
    out = pool.index_select(0, source_positions(new_off, starts, bcap,
                                                pool.shape[0]))
    return out.masked_fill_(~live, 0)


def _byte_selection(offsets: torch.Tensor, sel: torch.Tensor,
                    bcap: int) -> torch.Tensor:
    """(bcap,) bool: byte p is selected iff its row is (bytes past the
    last row are not). Each non-empty row writes at its first byte the
    change from the previous non-empty row's selection; a running sum of
    the int8 changes is the byte's selection. The per-byte work arrays are
    int8: no per-byte row ids."""
    cap = sel.shape[0]
    dev = sel.device
    starts = offsets[:-1]
    nonempty = offsets[1:] > starts
    s8 = (sel & nonempty).to(torch.int8)
    # the selection of the non-empty row before each row: compact the
    # non-empty rows' selections by rank, read rank - 2 (0 where none)
    rank = torch.cumsum(nonempty, 0)
    compact = _scatter(cap, 0, torch.where(nonempty, rank - 1, cap), s8)
    before = torch.where(rank >= 2, compact[(rank - 2).clamp_(0)], 0)
    last = compact[(rank[-1] - 1).clamp(0)] if cap else s8.new_zeros(())
    steps = torch.zeros((bcap + 1,), dtype=torch.int8, device=dev)
    steps.index_copy_(0, torch.where(nonempty, starts, bcap).long(),
                      (s8 - before).to(torch.int8))
    # bytes from the end of the rows on are dropped
    end = offsets[cap].long().clamp(max=bcap)
    steps.index_put_((end.reshape(1),), -last.reshape(1).to(torch.int8),
                     accumulate=True)
    return torch.cumsum(steps[:bcap], 0, dtype=torch.int8).view(torch.bool)


def take_batch(b: Batch, indices: Array) -> Batch:
    arrays = take_arrays(b.arrays, indices)
    return Batch(b.schema, arrays, indices.length, b.index)


def filter_array(values: Array, mask: Array,
                 options: Optional[FilterOptions] = None) -> Array:
    opts = options or FilterOptions()
    return take_array(values,
                      get_take_indices(mask, opts.null_selection_behavior))


def _filter_batch_columns(b: Batch, mask: Array,
                          null_selection: str) -> Batch:
    """Single-pass compaction (JAX ``_filter_batch_dma``): ONE kernel
    launch compacts every column's values (bool as bytes; a dictionary
    column's indices; a varlen column's row lengths) and validity (where there is one or nulls are emitted) as they lie, and
    gives the selected count; no byte planes are packed or unpacked. Each
    varlen column's pool then compacts through ``_filter_pool``."""
    sel, emit_valid, _ = _selection_mask(mask, null_selection, count=False)
    if b.capacity == 0:
        return b.with_length(torch.zeros((), dtype=torch.int32,
                                         device=sel.device))
    columns, has_validity = [], []
    # rows emitted as nulls take no bytes (as the take's null indices)
    keep = sel if emit_valid is None else sel & emit_valid
    for a in b.arrays:
        if a.offsets is not None:
            lens = a.offsets[1:] - a.offsets[:-1]
            if emit_valid is not None:
                lens = torch.where(emit_valid, lens, 0)
            columns.append(lens)
        else:
            # bool as bytes; a fixed-size binary's or a wide decimal's
            # (cap, w) rows as one (cap, bytes) u8 matrix
            v = a.values
            columns.append(v.contiguous().view(torch.uint8)
                           if v.dtype == torch.bool or v.ndim == 2 else v)
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
        if a.offsets is not None:
            lens = next(outs)
            validity = next(outs).view(torch.bool) if valid else None
            arrays.append(_filter_pool(a, keep, lens, out_len, validity))
            continue
        values = next(outs)
        if a.values.dtype == torch.bool or a.values.ndim == 2:
            values = values.view(a.values.dtype)
        validity = next(outs).view(torch.bool) if valid else None
        arrays.append(Array(a.type, values, validity, length=out_len,
                            dictionary=a.dictionary))
    return Batch(b.schema, arrays, out_len, b.index)


def _filter_pool(a: Array, sel: torch.Tensor, lens: torch.Tensor,
                 out_len, validity) -> Array:
    """A varlen column after the row compaction: its new offsets from the
    compacted lengths (rows past the count take none), its pool compacted
    by one more launch of the compaction kernel under the per-byte
    selection of the rows ``sel`` keeps bytes of."""
    cap = sel.shape[0]
    live = torch.arange(cap, dtype=torch.int32, device=sel.device) < out_len
    lens = torch.where(live, lens, 0)
    new_off = torch.cat([lens.new_zeros((1,)),
                         torch.cumsum(lens, 0, dtype=torch.int32)])
    pool = a.values
    if pool.shape[0]:
        byte_sel = _byte_selection(a.offsets, sel, pool.shape[0])
        (pool,), _ = filter_compact_columns(byte_sel, [pool])
    return Array(a.type, pool, validity, length=out_len, offsets=new_off)


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
    nested = [i for i in range(b.num_columns) if b.column(i).type.is_nested]
    if not nested:
        return _filter_batch_columns(b, mask, opts.null_selection_behavior)
    return _filter_batch_mixed(b, mask, opts.null_selection_behavior,
                               nested)


def _filter_batch_mixed(b: Batch, mask: Array, null_selection: str,
                        nested: list) -> Batch:
    """A batch with nested columns: its flat and varlen columns compact in
    the one launch of ``_filter_batch_columns``; its nested columns
    (list, struct, union, run-end encoded) are taken at ONE set of take
    indices (``get_take_indices``), as the JAX package's sort route takes
    them through its iota payload."""
    flat = [i for i in range(b.num_columns) if i not in nested]
    indices = get_take_indices(mask, null_selection)
    arrays = [None] * b.num_columns
    for i in nested:
        arrays[i] = take_array(b.column(i), indices)
    out_len = indices.length
    if flat:
        sub = Batch(Schema(tuple(b.schema.fields[i] for i in flat)),
                    [b.column(i) for i in flat], b.length, b.index)
        sub = _filter_batch_columns(sub, mask, null_selection)
        for i, a in zip(flat, sub.arrays):
            arrays[i] = a
        out_len = sub.length
    return Batch(b.schema, arrays, out_len, b.index)


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
