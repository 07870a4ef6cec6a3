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
  * varlen (string / binary) arrays carry ``offsets`` (int32, capacity +
    1) into a uint8 byte pool in ``values``, whose own length is the byte
    capacity; bytes past ``offsets[length]`` are unspecified.
  * dictionary arrays hold their indices in ``values`` and the dictionary
    as a child Array (``dictionary``).
  * nested layouts, as the JAX package has them: a list (and a map, a
    list whose child is the entries struct) keeps int32 ``offsets``
    (capacity + 1) into its child's rows, the child Array in the
    ``dictionary`` slot and an empty u8 ``values``; a fixed-size list of k
    has the offsets ``arange * k``; a struct (the two struct-layout
    interval types among them) keeps same-length ``children`` and a
    (capacity,) placeholder ``values``; a union keeps int8 type codes in
    ``values``, a dense union's value offsets in ``offsets``, its
    ``children``, and no validity; a run-end-encoded array keeps its run
    values in ``values`` and its run ends in ``offsets[1:]``.
  * constructors place their buffers on ``device``; with none given they
    take ``default_device()``, the card. ``Array.to(device)`` moves one,
    its children and its list child or dictionary with it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import datatype as dt

__all__ = ["Array", "array", "array_from_numpy", "varlen_from_numpy",
           "dictionary_from_numpy", "nulls", "full", "row_mask",
           "default_device", "resolve_device"]


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

    __slots__ = ("type", "values", "validity", "offsets", "dictionary",
                 "length", "children")

    def __init__(self, type: dt.DataType, values: torch.Tensor,
                 validity: Optional[torch.Tensor] = None, length=None,
                 offsets: Optional[torch.Tensor] = None,
                 dictionary: Optional["Array"] = None,
                 children: Optional[tuple] = None):
        self.type = type
        self.values = values
        self.validity = validity
        self.offsets = offsets
        self.dictionary = dictionary
        self.children = children
        if length is None:
            length = values.shape[0] if offsets is None \
                else offsets.shape[0] - 1
        self.length = length

    # ---- shape / capacity -------------------------------------------------
    @property
    def capacity(self) -> int:
        if self.offsets is not None:
            return self.offsets.shape[0] - 1
        return self.values.shape[0]

    @property
    def byte_capacity(self) -> Optional[int]:
        """The byte pool's size of a varlen array, else None."""
        return self.values.shape[0] if self.offsets is not None else None

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def has_static_length(self) -> bool:
        return _is_static_len(self.length)

    def __len__(self) -> int:
        return int(self.length)

    # ---- null handling ----------------------------------------------------
    @property
    def all_valid(self) -> bool:
        """True iff statically known to have no nulls."""
        return self.validity is None

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
        return Array(self.type, self.values, validity, self.length,
                     self.offsets, self.dictionary, self.children)

    def with_length(self, length) -> "Array":
        return Array(self.type, self.values, self.validity, length,
                     self.offsets, self.dictionary, self.children)

    def to(self, device) -> "Array":
        length = self.length if self.has_static_length \
            else self.length.to(device)
        return Array(self.type, self.values.to(device),
                     None if self.validity is None
                     else self.validity.to(device), length,
                     None if self.offsets is None
                     else self.offsets.to(device),
                     None if self.dictionary is None
                     else self.dictionary.to(device),
                     None if self.children is None
                     else tuple(c.to(device) for c in self.children))

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

    def to_numpy(self, zero_copy_only: bool = False):
        return self.to_pyarrow().to_numpy(zero_copy_only=zero_copy_only)


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


def _padded(values: np.ndarray, cap: int, dtype) -> np.ndarray:
    buf = np.zeros((cap,) + values.shape[1:], dtype=dtype)
    buf[:values.shape[0]] = values
    return buf


def _validity_tensor(validity, n: int, cap: int, device):
    if validity is None:
        return None
    return torch.from_numpy(_padded(np.asarray(validity, dtype=np.bool_),
                                    cap, np.bool_)).to(device)


def varlen_from_numpy(values=None, offsets=None, pool=None,
                      type: Optional[dt.DataType] = None, validity=None,
                      capacity: Optional[int] = None,
                      byte_capacity: Optional[int] = None,
                      device=None) -> Array:
    """A string (or binary) Array with no pyarrow: from a numpy ``bytes_``
    / ``str_`` array (``values``; utf-8 for ``str_``, trailing NUL bytes
    are not part of a ``bytes_`` element, as numpy has it), or from int32
    ``offsets`` (n + 1, from 0) and a uint8 ``pool``. Offsets past the
    length repeat the last one; the pool pads with zeros to
    ``byte_capacity`` (default: the used bytes, at least 1)."""
    device = resolve_device(device)
    if values is not None:
        values = np.asarray(values)
        if values.dtype.kind == "U":
            t = type or dt.string
            values = np.char.encode(values, "utf-8")
        else:
            t = type or dt.binary
        n = values.shape[0]
        width = values.dtype.itemsize
        mat = values.view(np.uint8).reshape(n, width)
        lens = np.char.str_len(values).astype(np.int64)
        offsets = np.zeros((n + 1,), np.int64)
        np.cumsum(lens, out=offsets[1:])
        pool = mat[np.arange(width)[None, :] < lens[:, None]]
    else:
        t = type or dt.string
        offsets = np.asarray(offsets, dtype=np.int64)
        pool = np.asarray(pool, dtype=np.uint8)
        n = offsets.shape[0] - 1
    if offsets[-1] >= (1 << 31):
        raise ValueError(f"a varlen column's pool of {offsets[-1]} bytes "
                         "does not fit int32 offsets: split the rows")
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < length {n}")
    nbytes = int(offsets[-1])
    bcap = max(nbytes, 1) if byte_capacity is None else byte_capacity
    if bcap < nbytes:
        raise ValueError(f"byte capacity {bcap} < {nbytes} bytes")
    off = np.full((cap + 1,), nbytes, np.int32)
    off[:n + 1] = offsets
    return Array(t, torch.from_numpy(_padded(pool[:nbytes], bcap,
                                             np.uint8)).to(device),
                 _validity_tensor(validity, n, cap, device), length=n,
                 offsets=torch.from_numpy(off).to(device))


def dictionary_from_numpy(indices, dictionary, validity=None,
                          capacity: Optional[int] = None,
                          index_type: dt.DataType = dt.int32,
                          device=None) -> Array:
    """A dictionary Array with no pyarrow: integer ``indices`` into
    ``dictionary`` (an Array, or numpy values that ``array_from_numpy``
    takes: a ``bytes_`` / ``str_`` array for a dictionary of strings).
    Null rows' indices are zeroed so that every index stays in range."""
    device = resolve_device(device)
    if not isinstance(dictionary, Array):
        dictionary = array_from_numpy(dictionary, device=device)
    idx = np.asarray(indices).astype(index_type.storage_np)
    if validity is not None:
        idx = np.where(np.asarray(validity, dtype=np.bool_), idx, 0)
    n = idx.shape[0]
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < length {n}")
    t = dt.DictionaryType(index_type, dictionary.type)
    return Array(t, torch.from_numpy(_padded(idx, cap, idx.dtype)).to(device),
                 _validity_tensor(validity, n, cap, device), length=n,
                 dictionary=dictionary)


def array_from_numpy(values, type: Optional[dt.DataType] = None,
                     validity=None, capacity: Optional[int] = None,
                     device=None) -> Array:
    """Build an Array from a numpy array (no pyarrow): fixed-width values,
    or a ``bytes_`` / ``str_`` array for a string column
    (``varlen_from_numpy``; dictionary columns: ``dictionary_from_numpy``).

    ``validity`` is an optional bool mask (False = null); ``capacity`` pads
    the buffers to a fixed size >= length; ``device`` places them."""
    device = resolve_device(device)
    values = np.asarray(values)
    if values.dtype.kind in "SU" or (type is not None and type.is_varlen):
        return varlen_from_numpy(values, type=type, validity=validity,
                                 capacity=capacity, device=device)
    t = type or _infer_type(values)
    if isinstance(t, dt.DictionaryType):
        raise TypeError("a dictionary column needs its dictionary: "
                        "dictionary_from_numpy(indices, values)")
    if not t.is_primitive:
        raise NotImplementedError(f"array_from_numpy for {t}")
    n = values.shape[0]
    cap = n if capacity is None else capacity
    if cap < n:
        raise ValueError(f"capacity {cap} < length {n}")
    width = value_row_shape(t)
    if values.shape[1:] != width:
        raise ValueError(f"{t} takes values of shape (n,) + {width}, "
                         f"not {values.shape}")
    buf = _padded(values.astype(t.storage_np, copy=False), cap, t.storage_np)
    return Array(t, torch.from_numpy(buf).to(device),
                 _validity_tensor(validity, n, cap, device), length=n)


def value_row_shape(t: dt.DataType) -> tuple:
    """The shape of one row's values: a fixed-size binary's bytes (w,), a
    wide decimal's two int64 limbs (2,) [low 64 bits, high signed 64]
    as the JAX package stores them, one element otherwise."""
    if isinstance(t, dt.FixedSizeBinaryType):
        return (t.byte_width,)
    if isinstance(t, dt.DecimalType) and t.wide:
        return (2,)
    return ()


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
    valid = torch.zeros((cap,), dtype=torch.bool, device=device)
    if type.is_varlen:
        return Array(type, torch.zeros((1,), dtype=torch.uint8,
                                       device=device), valid, length=n,
                     offsets=torch.zeros((cap + 1,), dtype=torch.int32,
                                         device=device))
    buf = torch.from_numpy(np.zeros((cap,) + value_row_shape(type),
                                    dtype=type.storage_np))
    dictionary = nulls(0, type.value_type, device=device) \
        if isinstance(type, dt.DictionaryType) else None
    return Array(type, buf.to(device), valid, length=n,
                 dictionary=dictionary)


def full(n: int, value, type: dt.DataType, capacity: Optional[int] = None,
         device=None) -> Array:
    """``n`` rows of ``value``: a fixed-width value, or a str / bytes for
    a string or binary type."""
    device = resolve_device(device)
    cap = capacity or max(n, 1)
    if type.is_varlen:
        one = value.encode("utf-8") if isinstance(value, str) else \
            bytes(value)
        w = len(one)
        pool = np.tile(np.frombuffer(one, np.uint8), cap) if w else \
            np.zeros((0,), np.uint8)
        off = np.minimum(np.arange(cap + 1, dtype=np.int64), n) * w
        return varlen_from_numpy(offsets=off, pool=pool[:n * w], type=type,
                                 capacity=cap, device=device).with_length(n)
    if not type.is_primitive or isinstance(type, dt.DictionaryType):
        raise NotImplementedError(f"full() of {type}")
    buf = torch.from_numpy(np.full((cap,), value, dtype=type.storage_np))
    return Array(type, buf.to(device), None, length=n)
