"""pyarrow <-> device-array interop for fixed-width (decimal and
fixed-size binary among them), string, binary, dictionary and nested
(list, fixed-size list, map, struct, union) columns, and the struct-layout
intervals.

The engine's boundary layer, as in the JAX package's ``core/interop.py``:
host Arrow buffers are staged into padded device buffers, and device
results export back as genuine pyarrow arrays so tests can compare
bit-for-bit. Packed validity bitmaps (Arrow) <-> bool bytemasks (device)
conversion lives here and only here.

pyarrow is imported inside the functions that need it, never at module
level: the package runs without it. Large string / binary columns arrive
with int32 offsets: ``table_from_pyarrow`` splits a record batch so that
every varlen pool fits them (``_split_for_pools``). Low-cardinality string
columns of big sources are dictionary-encoded on the host at staging time
(transparent dictionary ingest, as in the JAX package). Nested layouts
follow the JAX package's conventions (``core/array.py``); a large list is
cast to a list on the way in. Run-end-encoded columns have no interop, as
in the JAX package (``datatype.to_pyarrow_type`` raises for them).
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import List, Optional

import numpy as np
import torch

from . import datatype as dt
from .array import Array, _validity_tensor, resolve_device
from .batch import Batch, Table
from .schema import Schema

__all__ = ["array_from_pyarrow", "array_to_pyarrow",
           "batch_from_pyarrow", "batch_to_pyarrow", "pad_capacity",
           "table_from_pyarrow", "host_dictionary"]

# Capacity bucketing: pad to one of these row counts (the JAX package's
# recompilation buckets; kept so both packages stage the same capacity).
_BUCKETS = [1 << k for k in range(4, 31)]

# id of a device dictionary's values buffer -> (a weak reference to the
# buffer, the pyarrow dictionary it was staged from): host-side consumers
# read it back without a copy from the device; the entry goes with the
# buffer
_HOST_DICTS: dict = {}


def _remember_host_dictionary(values: torch.Tensor, pa_dict) -> None:
    key = id(values)
    _HOST_DICTS[key] = (weakref.ref(values,
                                    lambda _: _HOST_DICTS.pop(key, None)),
                        pa_dict)


def host_dictionary(dict_array: Optional[Array]):
    """The pyarrow array a dictionary Array was staged from, or None (then
    callers fetch it with ``array_to_pyarrow``)."""
    if dict_array is None:
        return None
    ref, pa_dict = _HOST_DICTS.get(id(dict_array.values), (None, None))
    return pa_dict if ref is not None and ref() is dict_array.values \
        else None


def pad_capacity(n: int, capacity: Optional[int] = None) -> int:
    if capacity is not None:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < length {n}")
        return capacity
    n = max(n, 1)
    for b in _BUCKETS:
        if b >= n:
            return b
    return n


def _unpack_bits(buf, offset: int, n: int) -> np.ndarray:
    bits = np.frombuffer(buf, dtype=np.uint8)
    return np.unpackbits(bits, count=offset + n,
                         bitorder="little")[offset:].astype(np.bool_)


def _unpack_validity(pa_arr, n: int) -> Optional[np.ndarray]:
    """Bool bytemask, or None if all-valid."""
    if pa_arr.null_count == 0 or pa_arr.buffers()[0] is None:
        return None
    return _unpack_bits(pa_arr.buffers()[0], pa_arr.offset, n)


def _pack_validity(mask: np.ndarray):
    import pyarrow as pa
    return pa.py_buffer(np.packbits(mask, bitorder="little").tobytes())


def _check_supported(t: dt.DataType):
    if isinstance(t, dt.DictionaryType):
        return _check_supported(t.value_type)
    if t.is_varlen:
        return
    if isinstance(t, dt.ListType):
        return _check_supported(t.value_type)
    if isinstance(t, (dt.StructType, dt.UnionType)):
        for _, ft in t.fields:
            _check_supported(ft)
        return
    if not t.is_primitive:
        raise NotImplementedError(f"interop for {t}")


def _is_varlen_pa(t) -> bool:
    import pyarrow as pa
    return pa.types.is_string(t) or pa.types.is_binary(t) or \
        pa.types.is_large_string(t) or pa.types.is_large_binary(t)


def array_from_pyarrow(pa_arr, capacity: Optional[int] = None,
                       device=None, byte_capacity: Optional[int] = None
                       ) -> Array:
    """A pyarrow array staged on ``device``: ``capacity`` rows (default:
    the row count's bucket); a varlen pool of ``byte_capacity`` bytes
    (default: the used bytes' bucket). String and binary views arrive as
    plain string and binary; large types with int32 offsets (their pool
    must fit them)."""
    import pyarrow as pa
    device = resolve_device(device)
    if isinstance(pa_arr, pa.ChunkedArray):
        pa_arr = pa_arr.combine_chunks()
    if pa.types.is_string_view(pa_arr.type):
        pa_arr = pa_arr.cast(pa.string())
    elif pa.types.is_binary_view(pa_arr.type):
        pa_arr = pa_arr.cast(pa.binary())
    n = len(pa_arr)
    cap = pad_capacity(n, capacity)
    t = dt.from_pyarrow_type(pa_arr.type)
    _check_supported(t)
    validity_np = _unpack_validity(pa_arr, n)
    validity = _validity_tensor(validity_np, n, cap, device)

    if isinstance(t, dt.DictionaryType):
        dict_arr = array_from_pyarrow(pa_arr.dictionary, device=device)
        _remember_host_dictionary(dict_arr.values, pa_arr.dictionary)
        indices = pa_arr.indices
        raw = np.frombuffer(indices.buffers()[1],
                            dtype=t.index_type.storage_np)
        idx = raw[indices.offset:indices.offset + n]
        # null slots may hold anything in pyarrow's indices: zero them so
        # that every index stays in range for gathers
        if validity_np is not None:
            idx = np.where(validity_np, idx, 0)
        buf = np.zeros((cap,), dtype=t.index_type.storage_np)
        buf[:n] = idx
        return Array(t, torch.from_numpy(buf).to(device), validity,
                     length=n, dictionary=dict_arr)

    if t.is_varlen:
        if pa.types.is_large_string(pa_arr.type) or \
                pa.types.is_large_binary(pa_arr.type):
            pa_arr = pa_arr.cast(pa.string() if pa.types.is_large_string(
                pa_arr.type) else pa.binary())
        raw_off = np.frombuffer(pa_arr.buffers()[1], dtype=np.int32)
        off = raw_off[pa_arr.offset:pa_arr.offset + n + 1].astype(np.int32)
        base = int(off[0])
        off = off - base
        nbytes = int(off[-1])
        bcap = pad_capacity(max(nbytes, 1), byte_capacity)
        data = np.zeros((bcap,), dtype=np.uint8)
        if pa_arr.buffers()[2] is not None and nbytes:
            data[:nbytes] = np.frombuffer(pa_arr.buffers()[2],
                                          dtype=np.uint8)[base:base + nbytes]
        offsets = np.full((cap + 1,), nbytes, dtype=np.int32)
        offsets[:n + 1] = off
        return Array(t, torch.from_numpy(data).to(device), validity,
                     length=n, offsets=torch.from_numpy(offsets).to(device))

    if isinstance(t, (dt.DayTimeIntervalType, dt.MonthDayNanoIntervalType)):
        return _interval_from_pyarrow(pa_arr, t, n, cap, validity, device)
    if isinstance(t, dt.ListType):
        return _list_from_pyarrow(pa_arr, t, n, cap, validity, device)
    if isinstance(t, dt.UnionType):
        return _union_from_pyarrow(pa_arr, t, n, cap, device)
    if isinstance(t, dt.StructType):
        # same-length children (``.field(i)``, not ``.flatten()``: a
        # child's validity stays its own, as ArrayData.child_data has it);
        # ``values`` is a (cap,) placeholder carrying the capacity
        children = tuple(array_from_pyarrow(pa_arr.field(i), capacity=cap,
                                            device=device)
                         for i in range(pa_arr.type.num_fields))
        return Array(t, torch.zeros((cap,), dtype=torch.uint8,
                                    device=device), validity, length=n,
                     children=children)

    if isinstance(t, dt.FixedSizeBinaryType):
        w = t.byte_width
        buf = np.zeros((cap, w), dtype=np.uint8)
        if n:
            raw = np.frombuffer(pa_arr.buffers()[1], dtype=np.uint8)
            buf[:n] = raw[pa_arr.offset * w:(pa_arr.offset + n) * w] \
                .reshape(n, w)
        return Array(t, torch.from_numpy(buf).to(device), validity,
                     length=n)
    if isinstance(t, dt.DecimalType):
        buf = np.zeros((cap, 2) if t.wide else (cap,), dtype=np.int64)
        buf[:n] = _decimal_values(pa_arr, t, n, validity_np)
        return Array(t, torch.from_numpy(buf).to(device), validity,
                     length=n)
    buf = np.zeros((cap,), dtype=t.storage_np)
    if isinstance(t, dt.BoolType):
        buf[:n] = _unpack_bits(pa_arr.buffers()[1], pa_arr.offset, n)
    else:
        raw = np.frombuffer(pa_arr.buffers()[1], dtype=t.storage_np)
        buf[:n] = raw[pa_arr.offset:pa_arr.offset + n]
    return Array(t, torch.from_numpy(buf).to(device), validity, length=n)


def _decimal_values(pa_arr, t, n: int, valid: Optional[np.ndarray]
                    ) -> np.ndarray:
    """A decimal column's scaled integers, as the JAX package stores them:
    precision up to 18 one int64 a row; above it (n, 2) int64 limbs [low
    64 bits, high signed 64 bits]. Arrow's wire holds 16 (decimal128) or
    32 (decimal256) little-endian bytes a value; a value past the storage
    raises, as in the JAX package. Null slots become 0."""
    words = t.bits // 64
    raw = np.frombuffer(pa_arr.buffers()[1], dtype="<i8").reshape(-1, words)
    raw = raw[pa_arr.offset:pa_arr.offset + n]
    keep = 2 if t.wide else 1
    sign = raw[:, keep - 1] >> 63       # the words above: sign extension
    bad = np.zeros((n,), np.bool_)
    for w_i in range(keep, words):
        bad |= raw[:, w_i] != sign
    if valid is not None:
        bad &= valid
    if bad.any():
        raise NotImplementedError(
            f"{t} value past the engine's "
            f"{'128' if t.wide else '64'}-bit scaled-integer range")
    out = np.array(raw[:, :keep] if t.wide else raw[:, 0], dtype=np.int64)
    if valid is not None:
        out[~valid] = 0
    return out


def _interval_from_pyarrow(pa_arr, t, n: int, cap: int, validity, device):
    """The intervals, struct-layout as the JAX package stages them: Arrow's
    packed (i32, i32[, i64]) records unpacked into one child a
    component."""
    packed = np.dtype([(nm, ft.storage_np) for nm, ft in t.fields])
    rec = None
    if pa_arr.buffers()[1] is not None and n:
        rec = np.frombuffer(pa_arr.buffers()[1], dtype=packed)[
            pa_arr.offset:pa_arr.offset + n]
    children = []
    for nm, ft in t.fields:
        buf = np.zeros((cap,), dtype=ft.storage_np)
        if rec is not None:
            buf[:n] = rec[nm]
        children.append(Array(ft, torch.from_numpy(buf).to(device), None,
                              length=n))
    return Array(t, torch.zeros((cap,), dtype=torch.uint8, device=device),
                 validity, length=n, children=tuple(children))


def _list_from_pyarrow(pa_arr, t, n: int, cap: int, validity, device):
    """list<T> and map<K, V> (a ListType whose child is the entries
    struct): int32 offsets into child rows, the child Array in the
    ``dictionary`` slot, an empty u8 ``values``. A fixed-size list's
    offsets are ``arange * k``, so the list kernels take it unchanged."""
    import pyarrow as pa
    if isinstance(t, dt.FixedSizeListType):
        k = t.list_size
        child = array_from_pyarrow(pa_arr.values.slice(pa_arr.offset * k,
                                                       n * k), device=device)
        off = np.arange(n + 1, dtype=np.int32) * k
    else:
        if pa.types.is_large_list(pa_arr.type):
            pa_arr = pa_arr.cast(pa.list_(pa_arr.type.value_field))
        raw = np.frombuffer(pa_arr.buffers()[1], dtype=np.int32)
        off = raw[pa_arr.offset:pa_arr.offset + n + 1].astype(np.int32)
        base = int(off[0])
        off = off - base
        child_pa = pa_arr.values
        if base or int(off[-1]) < len(child_pa):
            child_pa = child_pa.slice(base, int(off[-1]))
        child = array_from_pyarrow(child_pa, device=device)
    offsets = np.full((cap + 1,), off[-1], dtype=np.int32)
    offsets[:n + 1] = off
    return Array(t, torch.zeros((0,), dtype=torch.uint8, device=device),
                 validity, length=n, offsets=torch.from_numpy(offsets)
                 .to(device), dictionary=child)


def _union_from_pyarrow(pa_arr, t, n: int, cap: int, device):
    """A union: int8 type codes in ``values`` (padding rows take the first
    code), a dense union's value offsets in ``offsets`` (cap + 1, the last
    unused), the children in ``children``, no top-level validity (Arrow's
    union layout has none). A sparse union's children have the union's
    capacity."""
    codes = np.full((cap,), t.type_codes[0] if t.type_codes else 0,
                    dtype=np.int8)
    codes[:n] = np.frombuffer(pa_arr.buffers()[1], dtype=np.int8)[
        pa_arr.offset:pa_arr.offset + n]
    offsets = None
    if t.mode == "dense":
        off = np.zeros((cap + 1,), dtype=np.int32)
        off[:n] = np.frombuffer(pa_arr.buffers()[2], dtype=np.int32)[
            pa_arr.offset:pa_arr.offset + n]
        offsets = torch.from_numpy(off).to(device)
    sparse = t.mode == "sparse"
    children = tuple(array_from_pyarrow(pa_arr.field(i), capacity=cap
                                        if sparse else None, device=device)
                     for i in range(pa_arr.type.num_fields))
    return Array(t, torch.from_numpy(codes).to(device), None, length=n,
                 offsets=offsets, children=children)


def array_to_pyarrow(arr: Array):
    import pyarrow as pa
    n = len(arr)
    t = arr.type
    interval = isinstance(t, (dt.DayTimeIntervalType,
                              dt.MonthDayNanoIntervalType))
    if not interval:
        _check_supported(t)
    validity_buf = None
    null_count = 0
    if arr.validity is not None:
        v = arr.validity[:n].cpu().numpy()
        null_count = int((~v).sum())
        if null_count:
            validity_buf = _pack_validity(v)
    if interval:
        return _interval_to_pyarrow(arr, validity_buf, null_count)
    if isinstance(t, dt.DictionaryType):
        idx = arr.values[:n].cpu().numpy()
        indices = pa.Array.from_buffers(
            dt.to_pyarrow_type(t.index_type), n,
            [validity_buf, pa.py_buffer(np.ascontiguousarray(idx).tobytes())],
            null_count=null_count)
        out = pa.DictionaryArray.from_arrays(
            indices, array_to_pyarrow(arr.dictionary), ordered=t.ordered)
        # ingest-encoded columns decode back to their logical plain type
        return out.dictionary_decode() if t.transparent else out
    if t.is_nested:
        return _nested_to_pyarrow(arr, validity_buf, null_count)
    if t.is_varlen:
        off = arr.offsets[:n + 1].cpu().numpy().astype(np.int32)
        nbytes = int(off[-1])
        if nbytes > arr.values.shape[0]:
            raise ValueError(
                f"varlen byte-pool overflow: rows span {nbytes} bytes but "
                f"the pool holds {arr.values.shape[0]}: a take or join "
                "fanout repeated long rows past the pool; run again with a "
                "larger fanout or byte capacity")
        data = arr.values[:nbytes].cpu().numpy()
        return pa.Array.from_buffers(
            dt.to_pyarrow_type(t), n,
            [validity_buf, pa.py_buffer(off.tobytes()),
             pa.py_buffer(data.tobytes())], null_count=null_count)
    vals = arr.values[:n].cpu().numpy()
    if isinstance(t, dt.DecimalType):
        # the wire's words: the storage, then its sign extension
        words = t.bits // 64
        wide = np.empty((n, words), dtype="<i8")
        keep = 2 if t.wide else 1
        wide[:, :keep] = vals.reshape(n, keep)
        for w_i in range(keep, words):
            wide[:, w_i] = wide[:, keep - 1] >> 63
        data = wide
    elif isinstance(t, dt.BoolType):
        data = np.packbits(vals.astype(np.bool_), bitorder="little")
    else:
        data = np.ascontiguousarray(vals.astype(t.storage_np, copy=False))
    return pa.Array.from_buffers(
        dt.to_pyarrow_type(t), n,
        [validity_buf, pa.py_buffer(data.tobytes())], null_count=null_count)


def _nested_to_pyarrow(arr: Array, validity_buf, null_count: int):
    """List, fixed-size list, map, struct and union columns: the children
    exported recursively under the column's own buffers."""
    import pyarrow as pa
    n = len(arr)
    t = arr.type
    pa_type = dt.to_pyarrow_type(t)
    if isinstance(t, dt.ListType):
        off = arr.offsets[:n + 1].cpu().numpy().astype(np.int32)
        child = array_to_pyarrow(arr.dictionary.with_length(int(off[-1])))
        if isinstance(t, dt.FixedSizeListType):
            return pa.Array.from_buffers(pa_type, n, [validity_buf],
                                         null_count=null_count,
                                         children=[child])
        if isinstance(t, dt.MapType):
            # the entries struct's key field is not nullable
            child = child.cast(pa.struct([
                pa.field("key", dt.to_pyarrow_type(t.key_type),
                         nullable=False),
                pa.field("value", dt.to_pyarrow_type(t.item_type))]))
        return pa.Array.from_buffers(
            pa_type, n, [validity_buf, pa.py_buffer(off.tobytes())],
            null_count=null_count, children=[child])
    if isinstance(t, dt.UnionType):
        codes = pa.array(arr.values[:n].cpu().numpy().astype(np.int8),
                         type=pa.int8())
        names = [nm for nm, _ in t.fields]
        if t.mode == "sparse":
            return pa.UnionArray.from_sparse(
                codes, [array_to_pyarrow(c.with_length(n))
                        for c in arr.children],
                field_names=names, type_codes=list(t.type_codes))
        off = arr.offsets[:n].cpu().numpy().astype(np.int32)
        return pa.UnionArray.from_dense(
            codes, pa.array(off, type=pa.int32()),
            [array_to_pyarrow(c) for c in arr.children],
            field_names=names, type_codes=list(t.type_codes))
    return pa.Array.from_buffers(
        pa_type, n, [validity_buf], null_count=null_count,
        children=[array_to_pyarrow(c.with_length(n)) for c in arr.children])


def _interval_to_pyarrow(arr: Array, validity_buf, null_count: int):
    """The struct-layout intervals (the JAX package's interval branch):
    the components' children packed into Arrow's interval records, or a
    struct of them where pyarrow has no Python type for the interval
    (``datatype.to_pyarrow_type``)."""
    import pyarrow as pa
    n = len(arr)
    t = arr.type
    pa_type = dt.to_pyarrow_type(t)
    nulls = null_count if validity_buf else 0
    if pa.types.is_interval(pa_type):
        rec = np.zeros(n, dtype=np.dtype([(nm, ft.storage_np)
                                           for nm, ft in t.fields]))
        for (nm, _ft), c in zip(t.fields, arr.children):
            rec[nm] = c.values[:n].cpu().numpy()
        return pa.Array.from_buffers(
            pa_type, n, [validity_buf, pa.py_buffer(rec.tobytes())],
            null_count=nulls)
    return pa.Array.from_buffers(
        pa_type, n, [validity_buf], null_count=nulls,
        children=[array_to_pyarrow(c.with_length(n)) for c in arr.children])


# Transparent dictionary ingest (the JAX package's): plain string / binary
# columns of at least ARROW_TPU_DICT_INGEST_MIN rows whose distinct values
# number at most min(rows / 8, 2^16) are dictionary-encoded on the host at
# staging time, once per source, so every batch of the column shares one
# dictionary. Their logical type stays the plain one
# (``DictionaryType.transparent``): export decodes them. Off:
# ARROW_TPU_INGEST_DICT=0.
def _dict_ingest_min() -> int:
    return int(os.environ.get("ARROW_TPU_DICT_INGEST_MIN", str(1 << 16)))


def _dict_ingest_encode(tbl):
    """(tbl with its qualifying plain varlen columns dictionary-encoded,
    frozenset of their names)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = tbl.num_rows
    if os.environ.get("ARROW_TPU_INGEST_DICT", "1") != "1" or \
            n < _dict_ingest_min():
        return tbl, frozenset()
    names = set()
    cols = [tbl.column(i) for i in range(tbl.num_columns)]
    fields = list(tbl.schema)
    for i, f in enumerate(fields):
        if not _is_varlen_pa(f.type):
            continue
        col = cols[i]
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        enc = pc.dictionary_encode(col)
        if isinstance(enc, pa.ChunkedArray):
            enc = enc.combine_chunks()
        nd = len(enc.dictionary)
        if nd == 0 or nd > min(n // 8, 1 << 16):
            continue
        cols[i] = enc
        fields[i] = pa.field(f.name, enc.type, f.nullable)
        names.add(f.name)
    if not names:
        return tbl, frozenset()
    sch = pa.schema(fields)
    out = pa.table(cols, schema=sch) if isinstance(tbl, pa.Table) else \
        pa.record_batch(cols, schema=sch)
    return out, frozenset(names)


def _as_transparent(t: dt.DataType) -> dt.DataType:
    return dataclasses.replace(t, transparent=True)


def _mark_transparent_schema(schema: Schema, names) -> Schema:
    if not names:
        return schema
    from .schema import Field
    return Schema(tuple(
        Field(f.name, _as_transparent(f.type), f.nullable)
        if f.name in names and isinstance(f.type, dt.DictionaryType) else f
        for f in schema.fields))


def batch_from_pyarrow(rb, capacity: Optional[int] = None,
                       device=None, _transparent=frozenset(),
                       _ingest: bool = True) -> Batch:
    import pyarrow as pa
    if isinstance(rb, pa.Table):
        rb = rb.combine_chunks().to_batches()
        if len(rb) != 1:
            raise ValueError("batch_from_pyarrow takes one record batch")
        rb = rb[0]
    if not _transparent and _ingest:
        rb, _transparent = _dict_ingest_encode(rb)
    cap = pad_capacity(rb.num_rows, capacity)
    arrays = []
    for i in range(rb.num_columns):
        a = array_from_pyarrow(rb.column(i), capacity=cap, device=device)
        if rb.schema.field(i).name in _transparent and \
                isinstance(a.type, dt.DictionaryType):
            a = Array(_as_transparent(a.type), a.values, a.validity, a.length,
                      dictionary=a.dictionary)
        arrays.append(a)
    schema = _mark_transparent_schema(Schema.from_pyarrow(rb.schema),
                                      _transparent)
    return Batch(schema, arrays, rb.num_rows)


def batch_to_pyarrow(b: Batch):
    import pyarrow as pa
    n = len(b)
    cols = [array_to_pyarrow(b.column(i).with_length(n))
            for i in range(b.num_columns)]
    return pa.RecordBatch.from_arrays(cols, schema=b.schema.to_pyarrow())


# a batch's varlen byte pool must fit int32 offsets: ``table_from_pyarrow``
# cuts record batches whose pools are larger (the JAX package's limit;
# ARROW_TPU_MAX_POOL_BYTES lowers it for tests)
def _max_pool_bytes() -> int:
    return int(os.environ.get("ARROW_TPU_MAX_POOL_BYTES",
                              str((1 << 31) - (1 << 20))))


def _split_for_pools(rb, limit: int):
    """``rb`` cut into slices whose every varlen column's pool fits
    ``limit`` bytes: prefix sums of the row byte lengths, then greedy cuts
    at the last row that keeps every column under the limit (a single row
    over it stays alone; staging it raises)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = rb.num_rows
    cums = []
    for col in rb.columns:
        if _is_varlen_pa(col.type):
            lens = pc.binary_length(col).cast(pa.int64()).fill_null(0)
            cums.append(np.concatenate(
                [[0], np.cumsum(lens.to_numpy(zero_copy_only=False))]))
    if not cums or all(c[-1] <= limit for c in cums):
        return [rb]
    out = []
    start = 0
    while start < n:
        end = n
        for c in cums:
            end = min(end, int(np.searchsorted(c, c[start] + limit,
                                               side="right")) - 1)
        end = max(end, start + 1)
        out.append(rb.slice(start, end - start))
        start = end
    return out


def table_from_pyarrow(pa_table, max_rows_per_batch: Optional[int] = None,
                       capacity: Optional[int] = None, device=None,
                       dictionary_ingest: bool = True) -> Table:
    """A pyarrow Table as batches of at most ``max_rows_per_batch`` rows
    (default 2^15, ExecPlan::kMaxBatchSize's analog), each padded to
    ``capacity`` or its bucket, each cut further where a varlen pool would
    not fit int32 offsets; a table of no rows keeps the empty record
    batches pyarrow gives for it. Transparent dictionary ingest runs once
    for the whole table, so every batch of a column shares one
    dictionary; ``dictionary_ingest=False`` skips it, so the staged schema
    is the table's (a dataset scan's fragments then share one schema)."""
    import pyarrow as pa
    if max_rows_per_batch is None:
        max_rows_per_batch = 1 << 15
    pa_table = pa_table.combine_chunks()
    pa_table, transparent = _dict_ingest_encode(pa_table) \
        if dictionary_ingest else (pa_table, frozenset())
    has_varlen = any(_is_varlen_pa(f.type) for f in pa_table.schema)
    rbs = pa_table.to_batches(max_chunksize=max_rows_per_batch)
    batches: List[Batch] = []
    for rb in rbs:
        pieces = _split_for_pools(rb, _max_pool_bytes()) if has_varlen \
            else [rb]
        for piece in pieces:
            if piece.num_rows == 0:
                continue
            if len(pieces) > 1:     # rebase the slice's offsets to 0
                piece = pa.record_batch(
                    [pa.concat_arrays([c]) for c in piece.columns],
                    schema=piece.schema)
            batches.append(batch_from_pyarrow(
                piece, capacity=capacity, device=device,
                _transparent=transparent, _ingest=dictionary_ingest))
    if not batches:
        batches = [batch_from_pyarrow(rb, capacity=capacity, device=device,
                                      _transparent=transparent,
                                      _ingest=dictionary_ingest)
                   for rb in rbs]
    return Table(_mark_transparent_schema(
        Schema.from_pyarrow(pa_table.schema), transparent), batches)
