"""Port parity of ``core/tensor``: Tensor, SparseCOOTensor,
SparseCSRMatrix and SparseCSCMatrix against pyarrow (interop, IPC) and the
JAX package's (``to_dense``, ``mv`` / ``mm``) on the same numpy input made
from a seed. Dense results equal; float64 products within 1e-12 of the
JAX package's, relative to the largest magnitude."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu_torch import SparseCOOTensor, SparseCSCMatrix, \
    SparseCSRMatrix, Tensor

RTOL = 1e-12


@pytest.fixture
def dense():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(37, 29))
    a[rng.random(a.shape) < 0.7] = 0.0
    return a


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= RTOL * np.abs(want).max())


def test_tensor_roundtrip_and_ipc(dense):
    import pyarrow.ipc as ipc
    t = Tensor.from_numpy(dense, dim_names=["r", "c"], device="cpu")
    assert t.shape == (37, 29) and t.ndim == 2
    assert t.strides == pa.Tensor.from_numpy(dense).strides
    pt = t.to_pyarrow()
    assert pt.equals(pa.Tensor.from_numpy(dense, dim_names=["r", "c"]))
    assert Tensor.from_pyarrow(pt, device="cpu").equals(t)
    sink = pa.BufferOutputStream()
    ipc.write_tensor(Tensor.from_numpy(dense, device="cpu").to_pyarrow(),
                     sink)
    back = ipc.read_tensor(pa.BufferReader(sink.getvalue()))
    assert Tensor.from_pyarrow(back, device="cpu").equals(
        Tensor.from_numpy(dense, device="cpu"))


@pytest.mark.parametrize("capacity", [None, 512])
def test_coo_matches_pyarrow_and_jax(dense, capacity):
    coo = SparseCOOTensor.from_dense(dense, capacity=capacity, device="cpu")
    jcoo = at.SparseCOOTensor.from_dense(dense, capacity=capacity)
    np.testing.assert_array_equal(coo.to_dense().numpy(), dense)
    np.testing.assert_array_equal(coo.coords.numpy(),
                                  np.asarray(jcoo.coords))
    ref = pa.SparseCOOTensor.from_dense_numpy(dense)
    assert len(coo) == ref.non_zero_length == len(jcoo)
    back = SparseCOOTensor.from_pyarrow(coo.to_pyarrow(), device="cpu")
    np.testing.assert_array_equal(back.to_dense().numpy(), dense)
    t = coo.to_tensor()
    np.testing.assert_array_equal(t.to_numpy(), dense)


def test_coo_3d_and_dim_names():
    a = np.zeros((2, 3, 4))
    a[0, 1, 2] = 5.0
    a[1, 2, 3] = -1.0
    coo = SparseCOOTensor.from_dense(a, dim_names=["x", "y", "z"],
                                     device="cpu")
    np.testing.assert_array_equal(coo.to_dense().numpy(), a)
    assert coo.to_tensor().dim_names == ("x", "y", "z")


@pytest.mark.parametrize("cls,jcls", [
    (SparseCSRMatrix, at.SparseCSRMatrix),
    (SparseCSCMatrix, at.SparseCSCMatrix)])
def test_compressed_matches_pyarrow_and_jax(dense, cls, jcls):
    m = cls.from_dense(dense, device="cpu")
    jm = jcls.from_dense(dense)
    np.testing.assert_array_equal(m.to_dense().numpy(), dense)
    np.testing.assert_array_equal(m.indptr.numpy(), np.asarray(jm.indptr))
    back = cls.from_pyarrow(m.to_pyarrow(), device="cpu")
    np.testing.assert_array_equal(back.to_scipy().toarray(), dense)
    x = np.random.default_rng(4).normal(size=29)
    y = np.random.default_rng(5).normal(size=(29, 6))
    _close(m.mv(x).numpy(), jm.mv(x))
    _close(m.mm(y).numpy(), jm.mm(y))
    _close(m.mv(torch.from_numpy(x)).numpy(), dense @ x)


def test_padded_entries_scatter_past_the_end(dense):
    """Entries past ``nnz`` are padding, whatever they hold."""
    coo = SparseCOOTensor.from_dense(dense, capacity=1024, device="cpu")
    coo.data[len(coo):] = 7.0
    np.testing.assert_array_equal(coo.to_dense().numpy(), dense)
    csr = SparseCSRMatrix.from_dense(dense, device="cpu")
    padded = SparseCSRMatrix(
        torch.cat([csr.data, torch.full((8,), 9.0, dtype=torch.float64)]),
        csr.indptr, torch.cat([csr.indices, torch.zeros(8, dtype=
                                                         csr.indices.dtype)]),
        csr.shape, nnz=len(csr), device="cpu")
    np.testing.assert_array_equal(padded.to_dense().numpy(), dense)
    _close(padded.mv(np.ones(29)).numpy(), dense @ np.ones(29))
