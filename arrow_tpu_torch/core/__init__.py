from . import datatype
from .array import Array, array, array_from_numpy, dictionary_from_numpy, \
    full, nulls, row_mask, varlen_from_numpy
from .schema import Field, Schema, field, schema
from .batch import (Batch, Table, TableGroupBy, batch, batch_from_numpy,
                    empty_batch, table)
