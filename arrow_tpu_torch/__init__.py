"""arrow_tpu_torch — the PyTorch + CUDA port of arrow_tpu.

The same columnar model (types, Array/Batch with capacity + length and
bool-bytemask validity), function registry and operators as the JAX
package ``arrow_tpu``, on torch tensors; the Pallas TPU kernels become
CUDA kernels written for Hopper (``ops/cuda_kernels.py``, ``csrc/``).
Imports torch and never jax; pyarrow only inside the interop functions.
Constructors and entry points place data on ``default_device()``, the card,
unless the caller names a device (``device="cpu"``).
"""

from .core import datatype as types  # noqa: F401
from .core.datatype import (  # noqa: F401
    DataType, int8, int16, int32, int64, uint8, uint16, uint32, uint64,
    float16, float32, float64, bool_, string, binary, null, date32, date64,
    timestamp, time32, time64, duration, decimal128, dictionary, list_,
    struct, fixed_size_binary,
)
from .core.array import (  # noqa: F401
    Array, array, array_from_numpy, nulls, full, default_device,
)
from .core.schema import Field, Schema, field, schema  # noqa: F401
from .core.batch import (  # noqa: F401
    Batch, Table, TableGroupBy, batch, batch_from_numpy, empty_batch, table,
)
from .core.json_literals import array_from_json, batch_from_json  # noqa: F401
from .core.tensor import (  # noqa: F401
    SparseCOOTensor, SparseCSCMatrix, SparseCSRMatrix, Tensor,
)
from .compute.registry import ensure_kernels_loaded as _ekl

_ekl()
del _ekl

__version__ = "0.1.0"
