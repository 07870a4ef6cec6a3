"""Columnar Array: the device-resident equivalent of Arrow's ArrayData.

Reference model: ``cpp/src/arrow/array/data.h:85`` (ArrayData = type, length,
offset, buffers[], child_data[]). The same model as the JAX package's
``core/array.py``, held in torch tensors:

  * **capacity + length discipline** — every buffer has a fixed
    ``capacity`` (its allocated row count) and the array carries a
    ``length``: a Python int when it is known on the host, else a 0-d
    integer tensor on the array's device (a count computed on the device is
    never fetched just to build an Array). Rows in ``[length, capacity)``
    are padding with unspecified contents; kernels that reduce or reorder
    mask them explicitly via ``row_mask``.
  * **validity is a bool bytemask**, not Arrow's packed bitmap. ``None``
    means all-valid. Packing happens only at the pyarrow boundary
    (``core/interop.py``).
  * constructors place their buffers on ``device``; with none given they
    take ``default_device()``, the card. ``Array.to(device)`` moves one.

Fixed-width columns only in this package so far: varlen, dictionary and
nested layouts come with the kernels that need them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import datatype as dt

__all__ = ["Array", "array", "array_from_numpy", "nulls", "full",
           "row_mask", "default_device", "resolve_device"]


def default_device() -> torch.device:
    """Where an entry point places its data when the caller names no
    device: the card. It does not probe and give way: on a machine without
    one the allocation raises PyTorch's own error, and a caller that wants
    the CPU says ``device="cpu"``."""
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the default."""
    return default_device() if device is None else torch.device(device)


def _is_static_len(length) -> bool:
    return isinstance(length, (int, np.integer))


class Array:
    """One typed column with capacity+length discipline."""

    __slots__ = ("type", "values", "validity", "length")

    def __init__(self, type: dt.DataType, values: torch.Tensor,
                 validity: Optional[torch.Tensor] = None, length=None):
        self.type = type
        self.values = values
        self.validity = validity
        if length is None:
            length = values.shape[0]
        self.length = length

    # ---- shape / capacity -------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def has_static_length(self) -> bool:
        return _is_static_len(self.length)

    def __len__(self) -> int:
        return int(self.length)

    # ---- null handling ----------------------------------------------------
    def validity_or_true(self) -> torch.Tensor:
        if self.validity is not None:
            return self.validity
        return torch.ones((self.capacity,), dtype=torch.bool,
                          device=self.device)

    def null_count(self) -> int:
        """Host-side null count over the first ``length`` rows."""
        if self.validity is None:
            return 0
        return int((~self.validity[:len(self)]).sum())

    def row_mask(self) -> torch.Tensor:
        """(capacity,) bool — True for rows < length (non-padding)."""
        return row_mask(self.capacity, self.length, self.device)

    def present_mask(self) -> torch.Tensor:
        """(capacity,) bool — True for in-range AND valid rows."""
        m = self.row_mask()
        if self.validity is not None:
            m = m & self.validity
        return m

    # ---- convenience ------------------------------------------------------
    def with_validity(self, validity: Optional[torch.Tensor]) -> "Array":
        return Array(self.type, self.values, validity, self.length)

    def with_length(self, length) -> "Array":
        return Array(self.type, self.values, self.validity, length)

    def to(self, device) -> "Array":
        length = self.length if self.has_static_length \
            else self.length.to(device)
        return Array(self.type, self.values.to(device),
                     None if self.validity is None
                     else self.validity.to(device), length)

    def __repr__(self) -> str:
        ln = self.length if self.has_static_length else "<device>"
        return (f"Array<{self.type}>(length={ln}, capacity={self.capacity}, "
                f"nullable={self.validity is not None}, "
                f"device={self.device})")

    # ---- host conversion (pyarrow is imported only there) -----------------
    def to_pylist(self):
        return self.to_pyarrow().to_pylist()

    def to_pyarrow(self):
        from .interop import array_to_pyarrow
        return array_to_pyarrow(self)


def row_mask(capacity: int, length, device=None) -> torch.Tensor:
    """True for row indices < length (``length``: int or 0-d tensor)."""
    if isinstance(length, torch.Tensor):
        device = length.device
    return torch.arange(capacity, device=device) < length


# ---- constructors -----------------------------------------------------------

def _infer_type(npv: np.ndarray) -> dt.DataType:
    mapping = {
        np.dtype(np.bool_): dt.bool_,
        np.dtype(np.int8): dt.int8, np.dtype(np.int16): dt.int16,
        np.dtype(np.int32): dt.int32, np.dtype(np.int64): dt.int64,
        np.dtype(np.uint8): dt.uint8, np.dtype(np.uint16): dt.uint16,
        np.dtype(np.uint32): dt.uint32, np.dtype(np.uint64): dt.uint64,
        np.dtype(np.float16): dt.float16, np.dtype(np.float32): dt.float32,
        np.dtype(np.float64): dt.float64,
    }
    if npv.dtype in mapping:
        return mapping[npv.dtype]
    raise TypeError(f"cannot infer arrow_tpu_torch type for numpy {npv.dtype}")


def array_from_numpy(values, type: Optional[dt.DataType] = None,
                     validity=None, capacity: Optional[int] = None,
                     device=None) -> Array:
    """Build a fixed-width Array from a numpy array (no pyarrow).

    ``validity`` is an optional bool mask (False = null); ``capacity`` pads
    the buffers to a fixed size >= length; ``device`` places them."""
    device = resolve_device(device)
    values = np.asarray(values)
    t = type or _infer_type(values)
    if not t.is_primitive or isinstance(t, (dt.DictionaryType,
                                            dt.FixedSizeBinaryType)) \
            or (isinstance(t, dt.DecimalType) and t.wide):
        raise NotImplementedError(f"array_from_numpy for {t}")
    n = values.shape[0]
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < length {n}")
    buf = np.zeros((cap,), dtype=t.storage_np)
    buf[:n] = values.astype(t.storage_np, copy=False)
    valid = None
    if validity is not None:
        vb = np.zeros((cap,), dtype=np.bool_)
        vb[:n] = np.asarray(validity, dtype=np.bool_)
        valid = torch.from_numpy(vb).to(device)
    return Array(t, torch.from_numpy(buf).to(device), valid, length=n)


def array(values, type: Optional[dt.DataType] = None, validity=None,
          capacity: Optional[int] = None, device=None) -> Array:
    """Build an Array from host data: an Array (returned as is), a numpy
    array or list (``array_from_numpy``), or a pyarrow array
    (``core.interop.array_from_pyarrow``, which imports pyarrow)."""
    if isinstance(values, Array):
        return values
    if isinstance(values, (np.ndarray, list, tuple)):
        return array_from_numpy(values, type, validity, capacity, device)
    from .interop import array_from_pyarrow
    return array_from_pyarrow(values, capacity=capacity, device=device)


def nulls(n: int, type: dt.DataType, capacity: Optional[int] = None,
          device=None) -> Array:
    device = resolve_device(device)
    cap = capacity or max(n, 1)
    buf = torch.from_numpy(np.zeros((cap,), dtype=type.storage_np))
    return Array(type, buf.to(device),
                 torch.zeros((cap,), dtype=torch.bool, device=device),
                 length=n)


def full(n: int, value, type: dt.DataType, capacity: Optional[int] = None,
         device=None) -> Array:
    device = resolve_device(device)
    cap = capacity or max(n, 1)
    if not type.is_primitive:
        raise NotImplementedError("full() supports primitive types only")
    buf = torch.from_numpy(np.full((cap,), value, dtype=type.storage_np))
    return Array(type, buf.to(device), None, length=n)
