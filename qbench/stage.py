"""The raw columns as the port's Tables: views, nothing copied.

Each table becomes ``batch_rows``-row batches (the last one shorter) whose
Arrays are slices of the generator's tensors; a dictionary column's batches
share one dictionary Array.
"""

from __future__ import annotations

from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.array import Array
from arrow_tpu_torch.core.batch import Batch, Table
from arrow_tpu_torch.core.schema import Field, Schema

_TYPES = {"int32": dt.int32, "int64": dt.int64, "float64": dt.float64,
          "date32": dt.date32}


def table(columns: dict, batch_rows: int) -> Table:
    """A port Table of the raw ``{name: Column}`` of one table."""
    names = list(columns)
    n = columns[names[0]].rows
    types, dictionaries = {}, {}
    for name, col in columns.items():
        if col.rows != n:
            raise ValueError(f"column {name!r} has {col.rows} rows, not {n}")
        if col.kind == "dict":
            dictionaries[name] = Array(dt.string, col.pool,
                                       offsets=col.offsets)
            types[name] = dt.DictionaryType(dt.int32, dt.string)
        else:
            types[name] = _TYPES[col.kind]
    schema = Schema(tuple(Field(c, types[c], True) for c in names))
    batches = []
    for start in range(0, max(n, 1), batch_rows):
        stop = min(start + batch_rows, n)
        batches.append(Batch(schema, [
            Array(types[c], columns[c].values[start:stop],
                  dictionary=dictionaries.get(c)) for c in names],
            stop - start))
    return Table(schema, batches)
