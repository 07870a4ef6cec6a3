"""Dense and sparse tensors (reference: ``cpp/src/arrow/tensor.{h,cc}`` and
``cpp/src/arrow/sparse_tensor.cc``: Tensor, SparseCOOTensor,
SparseCSRMatrix, SparseCSCMatrix); the counterpart of the JAX package's
``core/tensor.py``.

A dense Tensor is one torch tensor plus Arrow's metadata (dim_names).
Sparse formats keep Arrow's index structure (COO coordinates, CSR / CSC
indptr + indices) as tensors with the capacity + length discipline of
columns: ``nnz`` is the live count (a host int or a 0-d tensor), the
buffers have a fixed capacity, and padded entries scatter past the end.
``to_dense`` is one scatter; ``mm`` / ``mv`` are ``torch.sparse`` products
of the COO form (the JAX package's ride ``jax.experimental.sparse.BCOO``;
neither package has a hand kernel for them).

Constructors place the buffers on ``device``, the card unless given;
pyarrow (``from_pyarrow`` / ``to_pyarrow``) and scipy (``from_scipy`` /
``to_scipy``) are imported only inside the functions that use them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .array import resolve_device

__all__ = ["Tensor", "SparseCOOTensor", "SparseCSRMatrix",
           "SparseCSCMatrix"]


def _np_strides(shape: Tuple[int, ...], itemsize: int) -> Tuple[int, ...]:
    strides = []
    acc = itemsize
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return tuple(reversed(strides))


def _names(dim_names) -> Optional[tuple]:
    return tuple(dim_names) if dim_names else None


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.from_numpy(np.require(x, requirements=["C", "W"])).to(
        resolve_device(device))


class Tensor:
    """Dense n-dim tensor: one torch tensor + dim names (``tensor.h``)."""

    __slots__ = ("data", "dim_names")

    def __init__(self, data, dim_names: Optional[Sequence[str]] = None,
                 device=None):
        self.data = _as_tensor(data, device)
        self.dim_names = _names(dim_names)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def strides(self):
        return _np_strides(self.shape, self.data.element_size())

    @property
    def is_contiguous(self):
        return True

    def dim_name(self, i: int) -> str:
        return self.dim_names[i] if self.dim_names else ""

    @classmethod
    def from_numpy(cls, arr: np.ndarray,
                   dim_names: Optional[Sequence[str]] = None,
                   device=None) -> "Tensor":
        return cls(arr, dim_names, device)

    def to_numpy(self) -> np.ndarray:
        return self.data.cpu().numpy()

    @classmethod
    def from_pyarrow(cls, t, device=None) -> "Tensor":
        names = t.dim_names or None
        if names is not None and not any(names):
            names = None   # an IPC read gives ['', ...] for unnamed dims
        return cls(t.to_numpy(), names, device)

    def to_pyarrow(self):
        import pyarrow as pa
        return pa.Tensor.from_numpy(
            self.to_numpy(), dim_names=list(self.dim_names)
            if self.dim_names else None)

    def equals(self, other: "Tensor") -> bool:
        return self.shape == other.shape and \
            self.dim_names == other.dim_names and \
            bool(np.array_equal(self.to_numpy(), other.to_numpy(),
                                equal_nan=True))

    def __repr__(self):
        return f"Tensor<{self.data.dtype}>{self.shape}"


class _SparseBase:
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape))

    def __len__(self):
        return int(self.nnz)

    @property
    def non_zero_length(self):
        return len(self)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def _live(self) -> torch.Tensor:
        """(C,) bool: the entries below ``nnz`` (the rest are padding)."""
        cap = self.data.shape[0]
        return torch.arange(cap, device=self.device) < torch.as_tensor(
            self.nnz, device=self.device)

    def _scatter_dense(self, flat: torch.Tensor) -> torch.Tensor:
        """The dense tensor of the entries at flat positions ``flat``:
        one scatter, padding entries past the end."""
        size = self.size
        pos = torch.where(self._live(), flat, size)
        out = torch.zeros((size + 1,), dtype=self.data.dtype,
                          device=self.device)
        out.index_put_((pos,), self.data)
        return out[:size].reshape(self.shape)

    def to_tensor(self) -> Tensor:
        return Tensor(self.to_dense(), self.dim_names)

    def _product(self, x) -> torch.Tensor:
        n = len(self)
        r, c = self._coords()
        idx = torch.stack([r[:n], c[:n]])
        m = torch.sparse_coo_tensor(idx, self.data[:n], self.shape,
                                    device=self.device,
                                    check_invariants=False).coalesce()
        return torch.sparse.mm(m, _as_tensor(x, self.device)
                               .to(self.data.dtype))

    def mv(self, x) -> torch.Tensor:
        """Sparse @ dense vector (a ``torch.sparse`` product)."""
        return self._product(_as_tensor(x, self.device)[:, None])[:, 0]

    def mm(self, x) -> torch.Tensor:
        """Sparse @ dense matrix (a ``torch.sparse`` product)."""
        return self._product(x)


class SparseCOOTensor(_SparseBase):
    """COO: data (C,), coords (C, ndim) int64; ``nnz`` the live count
    (``SparseCOOIndex``, sparse_tensor.h). Coordinate rows >= nnz are
    padding."""

    __slots__ = ("data", "coords", "shape", "dim_names", "nnz")

    def __init__(self, data, coords, shape, nnz=None,
                 dim_names: Optional[Sequence[str]] = None, device=None):
        self.data = _as_tensor(data, device)
        self.coords = _as_tensor(coords, self.data.device)
        self.shape = tuple(int(d) for d in shape)
        self.dim_names = _names(dim_names)
        self.nnz = self.data.shape[0] if nnz is None else nnz

    @classmethod
    def from_dense(cls, arr, dim_names=None, capacity: Optional[int] = None,
                   device=None) -> "SparseCOOTensor":
        """Staged on the host: the nonzeros in row-major order, padded to
        ``capacity``."""
        a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        idx = np.argwhere(a != 0)
        n = idx.shape[0]
        cap = max(capacity or n, 1)
        data = np.zeros((cap,), dtype=a.dtype)
        data[:n] = a[tuple(idx.T)] if n else a.reshape(-1)[:0]
        coords = np.zeros((cap, a.ndim), dtype=np.int64)
        coords[:n] = idx
        return cls(data, coords, a.shape, n, dim_names, device)

    def _coords(self):
        return self.coords[:, 0], self.coords[:, 1]

    def to_dense(self) -> torch.Tensor:
        strides = torch.tensor(
            [int(np.prod(self.shape[i + 1:], dtype=np.int64))
             for i in range(self.ndim)], dtype=torch.int64,
            device=self.device)
        return self._scatter_dense((self.coords.long() * strides).sum(1))

    @classmethod
    def from_pyarrow(cls, t, device=None) -> "SparseCOOTensor":
        data, coords = t.to_numpy()
        return cls(data.reshape(-1), coords, t.shape, data.shape[0],
                   t.dim_names or None, device)

    def to_pyarrow(self):
        import pyarrow as pa
        n = len(self)
        return pa.SparseCOOTensor.from_numpy(
            self.data[:n].cpu().numpy(), self.coords[:n].cpu().numpy(),
            self.shape, dim_names=list(self.dim_names)
            if self.dim_names else None)

    def __repr__(self):
        return (f"SparseCOOTensor<{self.data.dtype}>{self.shape} "
                f"nnz={len(self)}")


class _CompressedMatrix(_SparseBase):
    """CSR / CSC: indptr (major + 1,), indices (C,), data (C,)
    (``sparse_tensor.h`` SparseCSRIndex / SparseCSCIndex)."""

    _major_axis = 0  # CSR: rows are major; CSC overrides with 1

    def __init__(self, data, indptr, indices, shape, nnz=None,
                 dim_names=None, device=None):
        self.data = _as_tensor(data, device)
        self.indptr = _as_tensor(indptr, self.data.device)
        self.indices = _as_tensor(indices, self.data.device)
        self.shape = tuple(int(d) for d in shape)
        self.dim_names = _names(dim_names)
        self.nnz = self.data.shape[0] if nnz is None else nnz
        assert len(self.shape) == 2

    def _major_of_position(self) -> torch.Tensor:
        """(C,) major coordinate of each stored entry: a searchsorted over
        indptr, the inverse of the compression."""
        cap = self.data.shape[0]
        pos = torch.arange(cap, dtype=self.indptr.dtype, device=self.device)
        major = torch.searchsorted(self.indptr.contiguous(), pos,
                                   right=True) - 1
        return major.clamp_(0, self.shape[self._major_axis] - 1)

    def _coords(self):
        major = self._major_of_position()
        minor = self.indices.long()
        return (major, minor) if self._major_axis == 0 else (minor, major)

    def to_dense(self) -> torch.Tensor:
        r, c = self._coords()
        return self._scatter_dense(r * self.shape[1] + c)

    @classmethod
    def from_scipy(cls, m, dim_names=None, device=None):
        return cls(m.data, m.indptr, m.indices, m.shape, m.data.shape[0],
                   dim_names, device)

    def _scipy_cls(self):
        import scipy.sparse as sp
        return sp.csr_matrix if self._major_axis == 0 else sp.csc_matrix

    def to_scipy(self):
        n = len(self)
        return self._scipy_cls()(
            (self.data[:n].cpu().numpy(), self.indices[:n].cpu().numpy(),
             self.indptr.cpu().numpy()), shape=self.shape)

    @classmethod
    def from_dense(cls, arr, dim_names=None, device=None):
        import scipy.sparse as sp
        a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        kind = sp.csr_matrix if cls._major_axis == 0 else sp.csc_matrix
        return cls.from_scipy(kind(a), dim_names, device)

    @classmethod
    def from_pyarrow(cls, t, device=None):
        return cls.from_scipy(t.to_scipy(), t.dim_names or None, device)

    def to_pyarrow(self):
        import pyarrow as pa
        kind = pa.SparseCSRMatrix if self._major_axis == 0 \
            else pa.SparseCSCMatrix
        return kind.from_scipy(self.to_scipy(), dim_names=list(
            self.dim_names) if self.dim_names else None)

    def __repr__(self):
        return (f"{type(self).__name__}<{self.data.dtype}>{self.shape} "
                f"nnz={len(self)}")


class SparseCSRMatrix(_CompressedMatrix):
    _major_axis = 0


class SparseCSCMatrix(_CompressedMatrix):
    _major_axis = 1
