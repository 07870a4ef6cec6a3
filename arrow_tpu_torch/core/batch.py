"""Batch: a device RecordBatch — equal-capacity Arrays + one shared length.

Reference: ``cpp/src/arrow/record_batch.h:41`` and Acero's ExecBatch
(``compute/exec.h:174``); the counterpart of the JAX package's
``core/batch.py``. ``Table`` holds a result's batches; its query methods
(``group_by``, ``sort_by``, ``join``, ``filter``) and ``TableGroupBy`` come
with the plan engine (ROADMAP queue item A7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .array import Array, array as make_array, array_from_numpy, \
    resolve_device, row_mask
from .schema import Field, Schema

__all__ = ["Batch", "Table", "batch", "batch_from_numpy", "empty_batch"]


class Batch:
    """An ordered set of equal-capacity Arrays + shared length (a Python
    int, or a 0-d tensor on the batch's device)."""

    __slots__ = ("schema", "arrays", "length", "index")

    def __init__(self, schema: Schema, arrays: Sequence[Array], length=None,
                 index: int = -1):
        self.schema = schema
        self.arrays = tuple(arrays)
        if length is None:
            length = self.arrays[0].length if self.arrays else 0
        self.length = length
        self.index = index

    # ---- accessors ----------------------------------------------------------
    @property
    def num_columns(self) -> int:
        return len(self.arrays)

    @property
    def column_names(self) -> Tuple[str, ...]:
        return self.schema.names

    @property
    def capacity(self) -> int:
        if not self.arrays:
            return 0
        return self.arrays[0].capacity

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    @property
    def has_static_length(self) -> bool:
        return isinstance(self.length, (int, np.integer))

    def __len__(self) -> int:
        return int(self.length)

    def column(self, key: Union[int, str]) -> Array:
        if isinstance(key, int):
            a = self.arrays[key]
        else:
            i = self.schema.get_field_index(key)
            if i < 0:
                raise KeyError(key)
            a = self.arrays[i]
        return a.with_length(self.length)

    def __getitem__(self, key) -> Array:
        return self.column(key)

    def row_mask(self) -> torch.Tensor:
        return row_mask(self.capacity, self.length, self.device)

    # ---- manipulation -------------------------------------------------------
    def set_column(self, name: str, arr: Array,
                   nullable: bool = True) -> "Batch":
        i = self.schema.get_field_index(name)
        if i >= 0:
            fields = list(self.schema.fields)
            fields[i] = Field(name, arr.type, nullable)
            arrays = list(self.arrays)
            arrays[i] = arr
            return Batch(Schema(tuple(fields)), arrays, self.length,
                         self.index)
        return Batch(self.schema.append(Field(name, arr.type, nullable)),
                     list(self.arrays) + [arr], self.length, self.index)

    def with_length(self, length) -> "Batch":
        return Batch(self.schema, self.arrays, length, self.index)

    def to(self, device) -> "Batch":
        length = self.length if self.has_static_length \
            else self.length.to(device)
        return Batch(self.schema, [a.to(device) for a in self.arrays],
                     length, self.index)

    def __repr__(self) -> str:
        ln = self.length if self.has_static_length else "<device>"
        cols = ", ".join(f"{f.name}: {f.type}" for f in self.schema)
        return f"Batch[{ln}/{self.capacity}]({cols})"

    # ---- host conversion (pyarrow is imported only there) -----------------
    def to_pyarrow(self):
        from .interop import batch_to_pyarrow
        return batch_to_pyarrow(self)

    def to_pydict(self):
        return self.to_pyarrow().to_pydict()

    @staticmethod
    def from_pyarrow(rb, capacity: Optional[int] = None,
                     device=None) -> "Batch":
        from .interop import batch_from_pyarrow
        return batch_from_pyarrow(rb, capacity=capacity, device=device)


class Table:
    """Host-side container of Batches sharing a schema (Arrow's Table /
    ChunkedArray analog), for user-facing materialization: a distributed
    result holds one batch per shard that has rows, each on its shard's
    device."""

    def __init__(self, schema: Schema, batches: List[Batch]):
        self.schema = schema
        self.batches = list(batches)

    @property
    def num_rows(self) -> int:
        return sum(len(b) for b in self.batches)

    @property
    def num_columns(self) -> int:
        return len(self.schema)

    @property
    def column_names(self):
        return self.schema.names

    def to_pyarrow(self):
        import pyarrow as pa
        from .interop import batch_to_pyarrow
        if not self.batches:
            return self.schema.to_pyarrow().empty_table()
        return pa.Table.from_batches(
            [batch_to_pyarrow(b) for b in self.batches],
            schema=self.schema.to_pyarrow())

    def to_pydict(self):
        return self.to_pyarrow().to_pydict()

    def _one_batch(self) -> Batch:
        """All rows as ONE batch on the first batch's device (chunks are
        independent batches; cross-chunk operators combine first)."""
        if not self.batches:
            return Batch(self.schema, [], 0)
        if len(self.batches) == 1:
            return self.batches[0]
        dev = self.batches[0].device
        arrays = []
        for i, f in enumerate(self.schema.fields):
            cols = [b.column(i) for b in self.batches]
            values = torch.cat([c.values[:len(c)].to(dev) for c in cols])
            validity = None
            if any(c.validity is not None for c in cols):
                validity = torch.cat([c.validity_or_true()[:len(c)].to(dev)
                                      for c in cols])
            arrays.append(Array(f.type, values, validity))
        return Batch(self.schema, arrays, self.num_rows)

    def combine_chunks(self) -> "Table":
        """One batch holding all rows (Table.combine_chunks parity)."""
        if len(self.batches) <= 1:
            return self
        return Table(self.schema, [self._one_batch()])

    def equals(self, other) -> bool:
        o = other.to_pyarrow() if hasattr(other, "to_pyarrow") else other
        return self.to_pyarrow().equals(o)

    def __repr__(self) -> str:
        return (f"Table(rows={self.num_rows}, batches={len(self.batches)}, "
                f"cols={list(self.schema.names)})")


def empty_batch(schema: Schema, capacity: int = 16, device=None) -> Batch:
    """A batch of no rows with ``schema``'s fixed-width columns."""
    device = resolve_device(device)
    arrays = []
    for f in schema.fields:
        if f.type.is_varlen:
            raise NotImplementedError(f"empty_batch of {f.type} columns")
        values = torch.from_numpy(
            np.zeros((capacity,), dtype=f.type.storage_np)).to(device)
        validity = torch.zeros((capacity,), dtype=torch.bool, device=device) \
            if f.nullable else None
        arrays.append(Array(f.type, values, validity, length=0))
    return Batch(schema, arrays, 0)


def _from_columns(names, arrays) -> Batch:
    fields = tuple(Field(n, a.type, True) for n, a in zip(names, arrays))
    return Batch(Schema(fields), arrays,
                 arrays[0].length if arrays else 0)


def batch_from_numpy(data: Dict[str, np.ndarray], device=None,
                     capacity: Optional[int] = None) -> Batch:
    """Batch from a dict of numpy columns, placed on ``device`` (no
    pyarrow): the same columns the JAX package's ``batch`` takes."""
    names = list(data)
    return _from_columns(names, [array_from_numpy(data[n], capacity=capacity,
                                                  device=device)
                                 for n in names])


def batch(data: Dict[str, object], schema_: Optional[Schema] = None,
          capacity: Optional[int] = None, device=None) -> Batch:
    """Batch from a dict of columns (numpy / pyarrow / Arrays); see
    ``core.array.array`` for what each column may be."""
    names = list(data)
    return _from_columns(names, [
        make_array(data[n], type=schema_.field(n).type if schema_ else None,
                   capacity=capacity, device=device) for n in names])
