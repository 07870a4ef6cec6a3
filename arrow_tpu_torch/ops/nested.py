"""Nested (list, struct, map) kernels: list_value_length /
list_parent_indices / list_flatten / list_element / list_slice /
make_struct / struct_field / map_lookup, and the grouped ``list``
aggregator; the counterpart of the JAX package's ``ops/nested.py``.

Reference: ``cpp/src/arrow/compute/kernels/vector_nested.cc``,
``scalar_nested.cc`` and ``hash_aggregate.cc:1852`` (GroupedListImpl).

A list<T> Array carries row offsets in ``offsets`` and its child Array in
the ``dictionary`` slot (``core/array.py``); every list kernel here is
offset arithmetic and one gather (``rows_of_positions`` maps each child
row to its list row, ``take_array`` moves the child), the row / pool
pattern of the string kernels over child rows instead of bytes.

Where the port departs from the JAX package (ROADMAP C30, following
pyarrow): ``list_element`` raises ``ArrowInvalid`` for an index outside
[0, len) of a non-null list (one host read a call), where the JAX package
gives null or counts a negative index from the end; ``hash_list`` reports
a full buffer through ``error_flag`` (the JAX package drops the rows past
its buffer and reports nothing).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, full
from ..compute.registry import Kind, NullHandling, register_function
from ..utils import errors
from .aggregates import GROUPED_AGGREGATORS, GroupedAggregator
from .bits import as_signed_bits, gather_rows, zeros_of
from .segment import rows_of_positions
from .selection import filter_array, source_positions, take_array
from .strings import _prefix

__all__ = ["ListSliceOptions", "MakeStructOptions", "StructFieldOptions",
           "MapLookupOptions", "GroupedList"]

_I32MAX = (1 << 31) - 1


def _list_arg(a) -> Array:
    if not isinstance(a, Array) or not isinstance(a.type, dt.ListType):
        raise TypeError("expected a list array")
    return a


def _lengths(a: Array) -> torch.Tensor:
    return (a.offsets[1:] - a.offsets[:-1]).to(torch.int32)


def _child_source(a: Array, new_off: torch.Tensor, start=None,
                  step: int = 1) -> torch.Tensor:
    """Output child row p of list row r reads child row ``offsets[r] +
    start[r] + (p - new_off[r]) * step`` of ``a`` (``source_positions``),
    over the child's capacity."""
    base = a.offsets[:-1] if start is None else a.offsets[:-1] + start
    ccap = a.dictionary.capacity
    return source_positions(new_off, base, max(ccap, 1), ccap, step)


@register_function("list_value_length", Kind.SCALAR, 1,
                   null_handling=NullHandling.INTERSECTION)
def _list_value_length(args, options):
    a = _list_arg(args[0])
    return Array(dt.int32, _lengths(a), None, length=a.length)


@register_function("list_parent_indices", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _list_parent_indices(args, options):
    a = _list_arg(args[0])
    ccap = max(a.dictionary.capacity, 1)
    r = rows_of_positions(a.offsets, ccap).clamp_(0, max(a.capacity - 1, 0))
    return Array(dt.int64, r.to(torch.int64), None,
                 length=a.offsets[a.length])


@register_function("list_flatten", Kind.VECTOR, 1,
                   null_handling=NullHandling.COMPUTED)
def _list_flatten(args, options):
    """The list elements end to end, null lists skipped."""
    a = _list_arg(args[0])
    lens = torch.where(a.present_mask(), _lengths(a), 0)
    new_off = _prefix(lens)
    return take_array(a.dictionary, Array(dt.int32, _child_source(
        a, new_off), None, length=new_off[-1]))


class MakeStructOptions:
    def __init__(self, field_names=None):
        self.field_names = list(field_names) if field_names else None


class StructFieldOptions:
    def __init__(self, indices=None, name=None):
        self.indices = indices
        self.name = name


@register_function("make_struct", Kind.SCALAR, -1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=MakeStructOptions)
def _make_struct(args, options):
    """``scalar_nested.cc`` make_struct: N same-length columns as one
    struct column (never null at the struct level); a scalar argument is
    broadcast."""
    arrays = [a for a in args if isinstance(a, Array)]
    if not arrays:
        raise TypeError("make_struct requires at least one array input")
    names = options.field_names if options and options.field_names else \
        [str(i) for i in range(len(args))]
    if len(names) != len(args):
        raise ValueError("field_names length != number of inputs")
    cap = arrays[0].capacity
    length = arrays[0].length
    dev = arrays[0].device
    children = []
    for a in args:
        if not isinstance(a, Array):
            a = full(cap, a.as_py() if hasattr(a, "as_py") else a, a.type,
                     capacity=cap, device=dev).with_length(length)
        children.append(a)
    t = dt.struct([(n, c.type) for n, c in zip(names, children)])
    return Array(t, torch.zeros((cap,), dtype=torch.uint8, device=dev),
                 None, length=length, children=tuple(children))


@register_function("struct_field", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=StructFieldOptions)
def _struct_field(args, options):
    """``scalar_nested.cc`` struct_field: one child, the parent's validity
    merged into it (a null struct row has null fields)."""
    a = args[0]
    if not isinstance(a.type, dt.StructType) or a.children is None:
        raise TypeError("struct_field expects a struct array")
    idx = None
    if options is not None and options.indices is not None:
        idx = options.indices[0] if isinstance(
            options.indices, (list, tuple)) else options.indices
    elif options is not None and options.name is not None:
        idx = [n for n, _ in a.type.fields].index(options.name)
    if idx is None:
        raise ValueError("struct_field requires indices or name")
    child = a.children[idx]
    if a.validity is not None:
        child = child.with_validity(child.validity_or_true() & a.validity)
    return child


class ListSliceOptions:
    def __init__(self, start: int = 0, stop=None, step: int = 1,
                 return_fixed_size_list=None):
        self.start = start
        self.stop = stop
        self.step = step


@register_function("list_element", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _list_element(args, options):
    """scalar_nested.cc list_element: each row's child element at index
    i; null where the list is null. An index outside [0, len) of a
    non-null list raises ``ArrowInvalid``, as pyarrow does (ROADMAP C30
    (c): the JAX package gives null, and counts a negative index from the
    end)."""
    a = _list_arg(args[0])
    idx_arg = args[1]
    ccap = max(a.dictionary.capacity, 1)
    lens = _lengths(a)
    present = a.present_mask()
    if isinstance(idx_arg, Array):
        i = as_signed_bits(idx_arg.values).to(torch.int64)
        present = present & idx_arg.present_mask()
    else:
        i = torch.full((a.capacity,), int(idx_arg.as_py()),
                       dtype=torch.int64, device=a.device)
    bad = present & ((i < 0) | (i >= lens))
    errors.check(bad.any(), "Index out of bounds in list_element: an "
                 "index outside [0, len) of a non-null list")
    src = torch.where(present, a.offsets[:-1] + i, 0).clamp_(0, ccap - 1)
    out = take_array(a.dictionary, Array(dt.int32, src.to(torch.int32),
                                         None, length=a.length))
    return out.with_validity(out.validity_or_true() & present)


@register_function("list_slice", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ListSliceOptions)
def _list_slice(args, options):
    """scalar_nested.cc list_slice: each row's [start, stop) child window,
    stride ``step``, as a new list column."""
    a = _list_arg(args[0])
    if options is None:
        raise ValueError("list_slice requires options")
    step = int(options.step)
    if step < 1:
        raise ValueError("list_slice step must be >= 1")
    lens = _lengths(a)
    start = torch.clamp(torch.full_like(lens, int(options.start)), min=0)
    start = torch.minimum(start, lens)
    stop = lens if options.stop is None else torch.minimum(
        torch.clamp(torch.full_like(lens, int(options.stop)), min=0), lens)
    span = torch.clamp(stop - start, min=0)
    new_lens = torch.where(a.present_mask(), (span + (step - 1)) // step, 0)
    new_off = _prefix(new_lens)
    child = take_array(a.dictionary, Array(
        dt.int32, _child_source(a, new_off, start, step), None,
        length=new_off[-1]))
    return Array(a.type, a.values, a.validity, length=a.length,
                 offsets=new_off, dictionary=child)


class MapLookupOptions:
    def __init__(self, query_key=None, occurrence: str = "first"):
        assert occurrence in ("first", "last", "all")
        self.query_key = query_key
        self.occurrence = occurrence


@register_function("map_lookup", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=MapLookupOptions)
def _map_lookup(args, options):
    """scalar_nested.cc MapLookupFunctor (:734): each map row's value(s)
    whose entry key equals ``query_key``. "first" / "last" give the item
    type, "all" a list of it; no match (or a null map) gives null, never
    an empty list. first / last are a scatter-min / scatter-max of the
    matching child rows into their map rows (rows that do not match go to
    a dump slot past the end)."""
    from ..compute.registry import call_function
    a = args[0]
    if not isinstance(a.type, dt.MapType):
        raise TypeError("map_lookup expects a map array")
    if options is None or options.query_key is None:
        raise ValueError("map_lookup: query_key can't be empty or null")
    keys, items = a.dictionary.children
    ccap = max(keys.capacity, 1)
    cap = a.capacity
    dev = a.device
    qk = options.query_key
    if hasattr(qk, "as_py"):            # a pyarrow scalar: its value
        qk = qk.as_py()
    eq = call_function("equal", [keys, qk])
    hit = eq.values.to(torch.bool) & eq.validity_or_true()
    r = rows_of_positions(a.offsets, ccap).clamp_(0, max(cap - 1, 0)).long()
    cidx = torch.arange(ccap, dtype=torch.int64, device=dev)
    hit = hit[:ccap] & (cidx < a.offsets[cap])
    present = a.present_mask()
    at = torch.where(hit, r, cap)

    if options.occurrence == "all":
        lens = torch.zeros((cap + 1,), dtype=torch.int32, device=dev)
        lens = lens.index_add_(0, at, hit.to(torch.int32))[:cap]
        picked = filter_array(items, Array(dt.bool_, hit, None,
                                           length=a.offsets[cap]))
        return Array(dt.ListType(a.type.item_type), a.values,
                     present & (lens > 0), length=a.length,
                     offsets=_prefix(lens), dictionary=picked)

    if options.occurrence == "first":
        pos = torch.full((cap + 1,), ccap, dtype=torch.int64, device=dev)
        pos = pos.scatter_reduce_(0, at, cidx, "amin")[:cap]
        found = pos < ccap
    else:
        pos = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
        pos = pos.scatter_reduce_(0, at, cidx, "amax")[:cap]
        found = pos >= 0
    src = torch.where(found, pos, 0).to(torch.int32)
    out = take_array(items, Array(dt.int32, src, None, length=a.length))
    return out.with_validity(out.validity_or_true() & found & present)


class GroupedList(GroupedAggregator):
    """hash_list (``hash_aggregate.cc:1852``): each group's values, in
    input order, as a list. The state is the JAX package's: buffers of
    ``buffer_rows`` rows (an attribute of the options, default 2^16) of
    (group id, arrival, value, valid) and (count, base, error). Each
    consume appends the batch's whole capacity in place, inactive rows as
    group -1, as the JAX package does; past the buffer the error is set
    and ``error_flag`` reports it (ROADMAP C30 (a): the JAX package drops
    the rows and reports nothing). ``finalize`` orders the buffer by (group,
    arrival) with two stable sorts; the output is a list column whose child
    rides the ``dictionary`` slot. A bool column buffers as u8, a uint64
    column as its int64 bits."""

    dist_rows = False

    name = "list"
    default_rows = 1 << 16

    def __init__(self, in_type, G, options=None):
        super().__init__(in_type, G, options)
        self.rows = getattr(options, "buffer_rows", None) or \
            self.default_rows

    @property
    def out_type(self):
        return dt.list_(self.in_type)

    def _store_dtype(self):
        d = np.dtype(self.in_type.storage_np)
        return np.dtype(np.uint8) if d == np.bool_ else d

    def init(self, device=None):
        R = self.rows
        return (torch.full((R,), -1, dtype=torch.int32, device=device),
                torch.zeros((R,), dtype=torch.int64, device=device),
                zeros_of(self._store_dtype(), R, device),
                torch.ones((R,), dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def _append(self, state, gids, arrival, vals, ok):
        bg, ba, bv, bok, cnt, base, err = state
        n = gids.shape[0]
        if n > self.rows:       # can never fit: no write at all
            return bg, ba, bv, bok, cnt + n, base, err | 1
        err = err | (cnt + n > self.rows).to(torch.int32)
        at = torch.clamp(cnt, max=self.rows - n) + torch.arange(
            n, device=bg.device)
        bg.index_copy_(0, at, gids.to(torch.int32))
        ba.index_copy_(0, at, arrival)
        as_signed_bits(bv).index_copy_(0, at, as_signed_bits(vals))
        bok.index_copy_(0, at, ok)
        return bg, ba, bv, bok, cnt + n, base, err

    def consume(self, state, values, group_ids):
        cap = values.capacity
        base = state[5]
        v = values.values
        if v.dtype == torch.bool:
            v = v.to(torch.uint8)
        arrival = base + torch.arange(cap, dtype=torch.int64,
                                      device=v.device)
        out = self._append(state, torch.where(group_ids >= 0, group_ids, -1),
                           arrival, v, values.validity_or_true())
        return out[:5] + (base + cap, out[6])

    def merge(self, state, other, mapping):
        """Append the other buffer's used rows (one host read of its
        count), their groups mapped and their arrivals after this state's.
        The JAX package sorts the union of both whole buffers instead; the
        lists are the same."""
        og, oa, ov, ook, ocnt, obase, oerr = other
        used = min(int(ocnt), og.shape[0])
        m = torch.cat([mapping.to(torch.int32),
                       mapping.new_full((1,), -1).to(torch.int32)])
        og = og[:used]
        remap = m[torch.where(og >= 0, og.long().clamp(
            max=mapping.shape[0] - 1), mapping.shape[0])]
        remap = torch.where(remap >= self.G, -1, remap)
        base = state[5]
        out = self._append(state, remap, oa[:used] + base, ov[:used],
                           ook[:used])
        return out[:5] + (base + obase, out[6] | oerr)

    def error_flag(self, state) -> torch.Tensor:
        return state[6]

    def error_message(self, flag: int) -> str:
        return (f"{self.name}: more than {self.rows} rows buffered; raise "
                "buffer_rows (an attribute of the options) to cover the "
                "rows consumed")

    def finalize(self, state, num_groups) -> Array:
        bg, ba, bv, bok, _, _, _ = state
        dev = bg.device
        gkey = torch.where(bg >= 0, bg, _I32MAX)
        order = torch.sort(ba, stable=True).indices
        order = order[torch.sort(gkey[order], stable=True).indices]
        sg = gkey[order].contiguous()
        gidx = torch.arange(self.G, dtype=torch.int32, device=dev)
        counts = torch.searchsorted(sg, gidx, right=True) - \
            torch.searchsorted(sg, gidx)
        offsets = _prefix(counts)
        # the groups' runs lie in group order from row 0 of the sorted
        # buffer, so child row p IS sorted row p (the JAX package's
        # searchsorted gather reduces to this)
        cvals = gather_rows(bv, order)
        if self.in_type.storage_np == np.bool_:
            cvals = cvals.to(torch.bool)
        n = torch.as_tensor(num_groups, device=dev).long().clamp(0, self.G)
        child = Array(self.in_type, cvals, bok[order], length=offsets[n])
        return Array(self.out_type, torch.zeros((0,), dtype=torch.uint8,
                                                device=dev), None,
                     length=num_groups, offsets=offsets, dictionary=child)


GROUPED_AGGREGATORS["list"] = GroupedList
