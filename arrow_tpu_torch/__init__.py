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
    float16, float32, float64, bool_,
)
from .core.array import (  # noqa: F401
    Array, array, array_from_numpy, nulls, full, default_device,
)
from .core.schema import Field, Schema, field, schema  # noqa: F401
from .core.batch import (  # noqa: F401
    Batch, Table, batch, batch_from_numpy, empty_batch,
)
from .compute.registry import ensure_kernels_loaded as _ekl

_ekl()
del _ekl

__version__ = "0.1.0"
