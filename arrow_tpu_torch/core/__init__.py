from . import datatype
from .array import Array, array, array_from_numpy, nulls, full, row_mask
from .schema import Field, Schema, field, schema
from .batch import (Batch, Table, TableGroupBy, batch, batch_from_numpy,
                    empty_batch, table)
