"""JSON-literal constructors for golden tests.

The reference's test style builds arrays from JSON strings everywhere
(``ArrayFromJSON``, ``testing/gtest_util.h:209``). We reuse pyarrow's JSON
parsing so `array_from_json(int64, "[1, 2, null]")` has identical semantics.
"""

from __future__ import annotations

import json
from typing import Optional

from . import datatype as dt
from .array import Array
from .batch import Batch

__all__ = ["array_from_json", "batch_from_json"]


def array_from_json(type: dt.DataType, text: str,
                    capacity: Optional[int] = None, device=None) -> Array:
    import pyarrow as pa
    values = json.loads(text)
    pa_arr = pa.array(values, type=dt.to_pyarrow_type(type))
    from .interop import array_from_pyarrow
    return array_from_pyarrow(pa_arr, capacity=capacity, device=device)


def batch_from_json(schema, text: str, capacity: Optional[int] = None,
                    device=None) -> Batch:
    """schema: an arrow_tpu_torch Schema; text: JSON list of row
    objects."""
    import pyarrow as pa
    rows = json.loads(text)
    pa_schema = schema.to_pyarrow()
    cols = {f.name: [r.get(f.name) for r in rows] for f in pa_schema}
    rb = pa.RecordBatch.from_pydict(cols, schema=pa_schema)
    from .interop import batch_from_pyarrow
    return batch_from_pyarrow(rb, capacity=capacity, device=device)
