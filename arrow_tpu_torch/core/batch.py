"""Batch: a device RecordBatch — equal-capacity Arrays + one shared length.

Reference: ``cpp/src/arrow/record_batch.h:41`` and Acero's ExecBatch
(``compute/exec.h:174``); the counterpart of the JAX package's
``core/batch.py``. ``Table`` holds a result's batches; its query methods
(``group_by``, ``sort_by``, ``join``, ``filter``, ``slice``) and
``TableGroupBy`` run through the plan engine (``arrow_tpu_torch.acero``), as
pyarrow's do through Acero.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import datatype as dt
from .array import Array, array as make_array, array_from_numpy, nulls, \
    resolve_device, row_mask, value_row_shape
from .schema import Field, Schema

__all__ = ["Batch", "Table", "TableGroupBy", "batch", "batch_from_numpy",
           "empty_batch", "table"]


class Batch:
    """An ordered set of equal-capacity Arrays + shared length (a Python
    int, or a 0-d tensor on the batch's device)."""

    # ``_compacted``: host-side flag of the plan engine's compaction
    # decision (``acero/nodes.maybe_compact``), unset until it is made
    __slots__ = ("schema", "arrays", "length", "index", "_compacted")

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
    def select(self, names: Sequence[str]) -> "Batch":
        idxs = [self.schema.get_field_index(n) for n in names]
        return Batch(self.schema.select(names),
                     [self.arrays[i] for i in idxs], self.length, self.index)

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

    def with_index(self, index: int) -> "Batch":
        return Batch(self.schema, self.arrays, self.length, index)

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

    @staticmethod
    def from_pyarrow(pa_table, max_rows_per_batch: Optional[int] = None,
                     capacity: Optional[int] = None, device=None) -> "Table":
        from .interop import table_from_pyarrow
        return table_from_pyarrow(pa_table, max_rows_per_batch, capacity,
                                  device)

    @property
    def device(self) -> torch.device:
        """The first batch's device (the default device without one)."""
        return self.batches[0].device if self.batches and \
            self.batches[0].arrays else resolve_device(None)

    # ---- pyarrow.Table-parity query methods (through the plan engine, as
    # pyarrow's Table.group_by / join / sort_by run through Acero) --------
    def group_by(self, keys, aggregations=None, max_groups: int = 1 << 16,
                 use_threads: bool = True):
        """pyarrow parity (``table.pxi:6465``): ``group_by(keys)`` returns
        a TableGroupBy for ``.aggregate([...])``; passing ``aggregations``
        directly is the one-shot shorthand."""
        if isinstance(keys, str):
            keys = [keys]
        if aggregations is None:
            return TableGroupBy(self, list(keys), max_groups=max_groups)
        from ..acero import group_by as _gb
        aggs = [(a[1], a[0]) if isinstance(a, tuple) and len(a) == 2
                and not callable(a[0]) else a for a in aggregations]
        return _gb(self, keys, aggs, max_groups=max_groups)

    def sort_by(self, sorting) -> "Table":
        from ..acero import sort_by as _sb
        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        return _sb(self, sorting)

    def filter(self, expression) -> "Table":
        from ..acero import filter_table as _ft
        return _ft(self, expression)

    def join(self, right: "Table", keys, right_keys=None,
             join_type: str = "left outer",
             left_suffix: str = "", right_suffix: str = "",
             coalesce_keys: bool = True, **kw) -> "Table":
        """pyarrow parity (``Table.join``, ``acero.py`` ``_perform_join``):
        with ``coalesce_keys`` each key column appears once, the left's
        (the right's for a right outer join); a full outer join's key is
        the left key where the left row exists, else the right key (a
        ``coalesce`` of the two after the hashjoin node). Without it,
        every column of both sides, as the JAX package's ``join`` gives
        them."""
        from ..acero import (Declaration, HashJoinNodeOptions,
                             TableSourceNodeOptions)
        if isinstance(keys, str):
            keys = [keys]
        right_keys = right_keys or keys
        if isinstance(right_keys, str):
            right_keys = [right_keys]
        left_cols, right_cols = None, None
        if coalesce_keys:
            left_cols, right_cols = self.schema.names, right.schema.names
            if join_type in ("left semi", "left anti"):
                right_cols = []
            elif join_type in ("right semi", "right anti"):
                left_cols = []
            elif join_type in ("inner", "left outer"):
                right_cols = [c for c in right_cols if c not in right_keys]
            elif join_type == "right outer":
                left_cols = [c for c in left_cols if c not in keys]
        decl = Declaration("hashjoin", HashJoinNodeOptions(
            join_type, keys, right_keys, left_cols, right_cols,
            output_suffix_for_left=left_suffix,
            output_suffix_for_right=right_suffix, **kw), [
            Declaration("table_source", TableSourceNodeOptions(self)),
            Declaration("table_source", TableSourceNodeOptions(right)),
        ])
        out = decl.to_table()
        if coalesce_keys and join_type == "full outer":
            out = _coalesce_join_keys(out, left_cols, right_cols, keys,
                                      right_keys)
        return out

    # ---- structural methods (pyarrow.Table parity) -------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table(self.schema.select(names),
                     [b.select(names) for b in self.batches])

    def drop_columns(self, names) -> "Table":
        if isinstance(names, str):
            names = [names]
        drop = set(names)
        return self.select([n for n in self.schema.names if n not in drop])

    def rename_columns(self, names: Sequence[str]) -> "Table":
        if len(names) != len(self.schema):
            raise ValueError("rename_columns: wrong name count")
        schema = Schema(tuple(Field(n, f.type, f.nullable)
                              for n, f in zip(names, self.schema.fields)))
        return Table(schema, [Batch(schema, b.arrays, b.length, b.index)
                              for b in self.batches])

    def column(self, key):
        """Host-side column accessor (the chunks as one pyarrow column)."""
        return self.to_pyarrow().column(
            key if isinstance(key, str) else self.schema.names[key])

    def __getitem__(self, key):
        return self.column(key)

    def slice(self, offset: int = 0, length: Optional[int] = None
              ) -> "Table":
        from ..acero import Declaration, FetchNodeOptions, \
            TableSourceNodeOptions
        count = self.num_rows - offset if length is None else length
        return Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(self)),
            Declaration("fetch", FetchNodeOptions(offset, count)),
        ]).to_table()

    def _as_column(self, values, capacity: int) -> Array:
        """Host data (numpy, list, pyarrow) or an Array as an Array of
        ``capacity`` rows on the table's device."""
        if isinstance(values, Array):
            if values.capacity == capacity:
                return values
            if values.offsets is not None or \
                    values.capacity < capacity:
                from ..ops.concat import concat_arrays
                return concat_arrays([values], total_capacity=capacity)
            n = len(values)
            pad = capacity - n
            valid = None if values.validity is None else torch.cat(
                [values.validity[:n], values.validity.new_zeros(pad)])
            return Array(values.type, torch.cat(
                [values.values[:n], values.values.new_zeros(pad)]), valid,
                length=n, dictionary=values.dictionary)
        return make_array(values, capacity=capacity, device=self.device)

    def take(self, indices) -> "Table":
        """Row gather on the device through ``take_batch``; chunks combine
        first (the ChunkResolver step)."""
        from ..ops.selection import take_batch
        b = self._one_batch()
        idx = self._as_column(indices, max(len(indices), 1))
        return Table(self.schema, [take_batch(b, idx)])

    def append_column(self, name: str, values) -> "Table":
        """pyarrow Table.append_column parity: the new column is staged on
        the device, the existing ones stay where they are."""
        b = self._one_batch()
        col = self._as_column(values, max(b.capacity, 1))
        schema = Schema(tuple(self.schema.fields) +
                        (Field(name, col.type, True),))
        return Table(schema, [Batch(schema, list(b.arrays) + [col],
                                    b.length, b.index)])

    def set_column(self, i: int, name: str, values) -> "Table":
        """Replace column i (pyarrow Table.set_column parity)."""
        b = self._one_batch()
        col = self._as_column(values, max(b.capacity, 1))
        fields = list(self.schema.fields)
        fields[i] = Field(name, col.type, True)
        schema = Schema(tuple(fields))
        arrays = list(b.arrays)
        arrays[i] = col
        return Table(schema, [Batch(schema, arrays, b.length, b.index)])

    def cast(self, target_schema) -> "Table":
        """Column-wise cast through the registry's cast kernel; a pyarrow
        schema casts on the host through pyarrow, as in the JAX package."""
        from ..compute.registry import call_function
        from ..ops.scalar_cast import CastOptions
        if not isinstance(target_schema, Schema):
            dev = self.batches[0].device if self.batches else None
            return Table.from_pyarrow(self.to_pyarrow().cast(target_schema),
                                      device=dev)
        batches = []
        for b in self.batches:
            arrays = [call_function("cast", [b.column(i)],
                                    CastOptions(f.type))
                      for i, f in enumerate(target_schema.fields)]
            batches.append(Batch(target_schema, arrays, b.length, b.index))
        return Table(target_schema, batches)

    def drop_null(self) -> "Table":
        from ..compute.registry import call_function
        return Table(self.schema, [call_function("drop_null", [b])
                                   for b in self.batches])

    def _one_batch(self) -> Batch:
        """All rows as ONE batch on the first batch's device (chunks are
        independent batches; cross-chunk operators combine first)."""
        if not self.batches:
            return Batch(self.schema, [], 0)
        if len(self.batches) == 1:
            return self.batches[0]
        from ..ops.concat import concat_batches
        dev = self.batches[0].device
        return concat_batches([_trimmed(b.to(dev)) for b in self.batches])

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


class TableGroupBy:
    """pyarrow.TableGroupBy parity: holds (table, keys), ``aggregate``
    runs the grouped aggregation (``table.pxi`` TableGroupBy.aggregate).
    Aggregation entries are pyarrow-shaped: ``(column, "fn")``,
    ``(column, "fn", options)`` or ``([], "count_all")``."""

    def __init__(self, table: Table, keys, max_groups: int = 1 << 16):
        self.table = table
        self.keys = list(keys)
        self.max_groups = max_groups

    def aggregate(self, aggregations) -> Table:
        from ..acero import group_by as _gb
        from ..ops.hash_aggregate import AggregateSpec
        specs = []
        for a in aggregations:
            if isinstance(a, AggregateSpec):
                specs.append(a)
                continue
            target, fn = a[0], a[1]
            options = a[2] if len(a) > 2 else None
            if isinstance(target, list) and not target:
                target = None
            elif isinstance(target, (tuple, list)):
                target = tuple(target)
            specs.append(AggregateSpec(fn, target, options))
        return _gb(self.table, self.keys, specs, max_groups=self.max_groups)


def _coalesce_join_keys(out: Table, left_cols, right_cols, keys,
                        right_keys) -> Table:
    """A full outer join's output (``left_cols`` then ``right_cols``) with
    each left key column replaced by ``coalesce(left key, right key)`` and
    the right key columns dropped: pyarrow's projection after the join."""
    nl = len(left_cols)
    pair = {left_cols.index(k): nl + right_cols.index(rk)
            for k, rk in zip(keys, right_keys)}
    drop = set(pair.values())
    keep = [i for i in range(len(out.schema)) if i not in drop]
    # a coalesced key keeps its own name (no suffix), as pyarrow's
    names = {left_cols.index(k): k for k in keys}
    schema = Schema(tuple(Field(names[i], f.type, f.nullable)
                          if i in names else f
                          for i, f in ((i, out.schema.fields[i])
                                       for i in keep)))
    batches = []
    for b in out.batches:
        arrays = [_coalesce_pair(b.column(i), b.column(pair[i]))
                  if i in pair else b.arrays[i] for i in keep]
        batches.append(Batch(schema, arrays, b.length, b.index))
    return Table(schema, batches)


def _coalesce_pair(a: Array, b: Array) -> Array:
    """``coalesce(a, b)`` of two key columns of one batch, of any key type:
    ``a``'s row where it is valid, else ``b``'s. A dictionary's codes
    point into the two dictionaries side by side (``b``'s codes shifted
    past ``a``'s dictionary) unless both share one; a varlen column is a
    take of the two concatenated; other values (a (cap, w) decimal too) a
    ``torch.where`` of their bits."""
    from ..ops.bits import as_signed_bits
    ok_a = a.validity_or_true()
    if a.type.is_varlen:
        from ..ops.concat import concat_arrays
        from ..ops.selection import take_array
        cap = a.capacity
        both = concat_arrays([a.with_length(cap), b.with_length(cap)])
        rows = torch.arange(cap, device=a.device)
        got = take_array(both, Array(dt.int64, torch.where(ok_a, rows,
                                                           rows + cap)))
        return got.with_length(a.length)
    dictionary, vb = a.dictionary, b.values
    if isinstance(a.type, dt.DictionaryType) and dictionary is not \
            b.dictionary:
        from ..ops.concat import concat_arrays
        vb = vb + int(dictionary.length)
        dictionary = concat_arrays([dictionary, b.dictionary])
    va = a.values
    cond = ok_a.reshape(ok_a.shape + (1,) * (va.ndim - 1))
    values = torch.where(cond, as_signed_bits(va), as_signed_bits(vb)) \
        .view(va.dtype)
    return Array(a.type, values, ok_a | b.validity_or_true(),
                 length=a.length, dictionary=dictionary)


def empty_batch(schema: Schema, capacity: int = 16, device=None) -> Batch:
    """A batch of no rows with ``schema``'s columns (a varlen column with
    a 16-byte pool, a dictionary column with an empty dictionary, a list
    column with an empty child, a struct or union column with empty
    children)."""
    device = resolve_device(device)
    return Batch(schema, [_empty_array(f.type, capacity, f.nullable, device)
                          for f in schema.fields], 0)


def _empty_array(t, capacity: int, nullable: bool, device) -> Array:
    validity = torch.zeros((capacity,), dtype=torch.bool, device=device) \
        if nullable and not isinstance(t, dt.UnionType) else None
    offsets = torch.zeros((capacity + 1,), dtype=torch.int32, device=device)
    if t.is_varlen:
        return Array(t, torch.zeros((16,), dtype=torch.uint8, device=device),
                     validity, length=0, offsets=offsets)
    if isinstance(t, dt.ListType):
        return Array(t, torch.zeros((0,), dtype=torch.uint8, device=device),
                     validity, length=0, offsets=offsets,
                     dictionary=_empty_array(t.value_type, 16, True, device))
    if isinstance(t, (dt.StructType, dt.UnionType)):
        union = isinstance(t, dt.UnionType)
        dense = union and t.mode == "dense"
        return Array(t, torch.zeros((capacity,), dtype=torch.int8 if union
                                    else torch.uint8, device=device),
                     validity, length=0, offsets=offsets if dense else None,
                     children=tuple(_empty_array(
                         ft, 16 if dense else capacity, True, device)
                         for _, ft in t.fields))
    values = torch.from_numpy(
        np.zeros((capacity,) + value_row_shape(t), dtype=t.storage_np)
    ).to(device)
    dictionary = nulls(0, t.value_type, device=device) \
        if isinstance(t, dt.DictionaryType) else None
    return Array(t, values, validity, length=0, dictionary=dictionary)


def _trimmed(b: Batch) -> Batch:
    """``b`` sliced to its rows (a host read of a device length): a varlen
    column keeps its pool whole."""
    n = len(b)
    return Batch(b.schema, [
        a.with_length(n) if a.type.is_nested else
        Array(a.type, a.values if a.offsets is not None else a.values[:n],
              None if a.validity is None else a.validity[:n], n,
              None if a.offsets is None else a.offsets[:n + 1], a.dictionary)
        for a in b.arrays], n, b.index)


def _from_columns(names, arrays) -> Batch:
    fields = tuple(Field(n, a.type, True) for n, a in zip(names, arrays))
    return Batch(Schema(fields), arrays,
                 arrays[0].length if arrays else 0)


def batch_from_numpy(data: Dict[str, np.ndarray], device=None,
                     capacity: Optional[int] = None) -> Batch:
    """Batch from a dict of numpy columns, placed on ``device`` (no
    pyarrow): the same columns the JAX package's ``batch`` takes. A
    ``bytes_`` / ``str_`` column becomes a string column; a column may
    also be an Array already built (``varlen_from_numpy``,
    ``dictionary_from_numpy``), taken as it is."""
    names = list(data)
    return _from_columns(names, [
        data[n] if isinstance(data[n], Array) else
        array_from_numpy(data[n], capacity=capacity, device=device)
        for n in names])


def batch(data: Dict[str, object], schema_: Optional[Schema] = None,
          capacity: Optional[int] = None, device=None) -> Batch:
    """Batch from a dict of columns (numpy / pyarrow / Arrays); see
    ``core.array.array`` for what each column may be."""
    names = list(data)
    return _from_columns(names, [
        make_array(data[n], type=schema_.field(n).type if schema_ else None,
                   capacity=capacity, device=device) for n in names])


def table(data, capacity: Optional[int] = None, device=None) -> Table:
    """A single-batch Table from a dict of columns (see ``batch``), or a
    Table of a pyarrow Table."""
    if not isinstance(data, dict):
        return Table.from_pyarrow(data, capacity=capacity, device=device)
    b = batch(data, capacity=capacity, device=device)
    return Table(b.schema, [b])
