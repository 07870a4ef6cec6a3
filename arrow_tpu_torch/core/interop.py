"""pyarrow <-> device-array interop for fixed-width columns.

The engine's boundary layer, as in the JAX package's ``core/interop.py``:
host Arrow buffers are staged into padded device buffers, and device
results export back as genuine pyarrow arrays so tests can compare
bit-for-bit. Packed validity bitmaps (Arrow) <-> bool bytemasks (device)
conversion lives here and only here.

pyarrow is imported inside the functions that need it, never at module
level: the package runs without it. Primitive and bool columns only;
strings, dictionary ingest and nested types come later.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import datatype as dt
from .array import Array, resolve_device
from .batch import Batch, Table
from .schema import Schema

__all__ = ["array_from_pyarrow", "array_to_pyarrow",
           "batch_from_pyarrow", "batch_to_pyarrow", "pad_capacity",
           "table_from_pyarrow"]

# Capacity bucketing: pad to one of these row counts (the JAX package's
# recompilation buckets; kept so both packages stage the same capacity).
_BUCKETS = [1 << k for k in range(4, 31)]


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


def _check_fixed_width(t: dt.DataType):
    if not t.is_primitive or isinstance(
            t, (dt.DictionaryType, dt.FixedSizeBinaryType, dt.DecimalType)):
        raise NotImplementedError(f"interop for {t}")


def array_from_pyarrow(pa_arr, capacity: Optional[int] = None,
                       device=None) -> Array:
    import pyarrow as pa
    device = resolve_device(device)
    if isinstance(pa_arr, pa.ChunkedArray):
        pa_arr = pa_arr.combine_chunks()
    n = len(pa_arr)
    cap = pad_capacity(n, capacity)
    t = dt.from_pyarrow_type(pa_arr.type)
    _check_fixed_width(t)
    validity = None
    validity_np = _unpack_validity(pa_arr, n)
    if validity_np is not None:
        v = np.zeros((cap,), dtype=np.bool_)
        v[:n] = validity_np
        validity = torch.from_numpy(v).to(device)
    buf = np.zeros((cap,), dtype=t.storage_np)
    if isinstance(t, dt.BoolType):
        buf[:n] = _unpack_bits(pa_arr.buffers()[1], pa_arr.offset, n)
    else:
        raw = np.frombuffer(pa_arr.buffers()[1], dtype=t.storage_np)
        buf[:n] = raw[pa_arr.offset:pa_arr.offset + n]
    return Array(t, torch.from_numpy(buf).to(device), validity, length=n)


def array_to_pyarrow(arr: Array):
    import pyarrow as pa
    n = len(arr)
    t = arr.type
    _check_fixed_width(t)
    validity_buf = None
    null_count = 0
    if arr.validity is not None:
        v = arr.validity[:n].cpu().numpy()
        null_count = int((~v).sum())
        if null_count:
            validity_buf = _pack_validity(v)
    vals = arr.values[:n].cpu().numpy()
    if isinstance(t, dt.BoolType):
        data = np.packbits(vals.astype(np.bool_), bitorder="little")
    else:
        data = np.ascontiguousarray(vals.astype(t.storage_np, copy=False))
    return pa.Array.from_buffers(
        dt.to_pyarrow_type(t), n,
        [validity_buf, pa.py_buffer(data.tobytes())], null_count=null_count)


def batch_from_pyarrow(rb, capacity: Optional[int] = None,
                       device=None) -> Batch:
    import pyarrow as pa
    if isinstance(rb, pa.Table):
        rb = rb.combine_chunks().to_batches()
        if len(rb) != 1:
            raise ValueError("batch_from_pyarrow takes one record batch")
        rb = rb[0]
    cap = pad_capacity(rb.num_rows, capacity)
    arrays = [array_from_pyarrow(rb.column(i), capacity=cap, device=device)
              for i in range(rb.num_columns)]
    return Batch(Schema.from_pyarrow(rb.schema), arrays, rb.num_rows)


def batch_to_pyarrow(b: Batch):
    import pyarrow as pa
    n = len(b)
    cols = [array_to_pyarrow(b.column(i).with_length(n))
            for i in range(b.num_columns)]
    return pa.RecordBatch.from_arrays(cols, schema=b.schema.to_pyarrow())


def table_from_pyarrow(pa_table, max_rows_per_batch: Optional[int] = None,
                       capacity: Optional[int] = None, device=None) -> Table:
    """A pyarrow Table as batches of at most ``max_rows_per_batch`` rows
    (default 2^15, ExecPlan::kMaxBatchSize's analog), each padded to
    ``capacity`` or its bucket; a table of no rows keeps the empty record
    batches pyarrow gives for it."""
    if max_rows_per_batch is None:
        max_rows_per_batch = 1 << 15
    pa_table = pa_table.combine_chunks()
    rbs = pa_table.to_batches(max_chunksize=max_rows_per_batch)
    batches = [batch_from_pyarrow(rb, capacity=capacity, device=device)
               for rb in rbs if rb.num_rows]
    if not batches:
        batches = [batch_from_pyarrow(rb, capacity=capacity, device=device)
                   for rb in rbs]
    return Table(Schema.from_pyarrow(pa_table.schema), batches)
