"""Port parity: ``arrow_tpu_torch.ops.concat`` against the JAX package's
``ops/concat`` for fixed-width columns, with host and device lengths."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops import concat as jconcat
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    batch_from_pyarrow
from arrow_tpu_torch.ops import concat as tconcat


def _chunks(rng, t, sizes, nulls):
    out = []
    for i, n in enumerate(sizes):
        v = rng.integers(0, 100, n)
        mask = rng.random(n) < 0.3 if (nulls and i != 1) else None
        out.append(pa.array(v, mask=mask).cast(t))
    return out


def _same(got, want):
    n = int(want.length)
    assert int(got.length) == n and got.capacity == want.capacity
    np.testing.assert_array_equal(got.values.numpy()[:n],
                                  np.asarray(want.values)[:n])
    assert (got.validity is None) == (want.validity is None)
    if want.validity is not None:
        np.testing.assert_array_equal(got.validity.numpy()[:n],
                                      np.asarray(want.validity)[:n])


@pytest.mark.parametrize("t", [pa.int64(), pa.int32(), pa.float64(),
                               pa.float32(), pa.uint16(), pa.uint64(),
                               pa.bool_()], ids=str)
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "nulls"])
@pytest.mark.parametrize("device_lengths", [False, True],
                         ids=["host_len", "device_len"])
def test_concat_arrays_vs_jax(t, nulls, device_lengths):
    rng = np.random.default_rng(7)
    chunks = _chunks(rng, t, [50, 0, 33, 120], nulls)
    caps = [64, 16, 33, 128]
    want = jconcat.concat_arrays(
        [at.array(c, capacity=k) for c, k in zip(chunks, caps)])
    tas = [array_from_pyarrow(c, capacity=k, device="cpu")
           for c, k in zip(chunks, caps)]
    if device_lengths:
        tas = [a.with_length(torch.tensor(int(a.length), dtype=torch.int32))
               for a in tas]
    got = tconcat.concat_arrays(tas)
    assert isinstance(got.length, torch.Tensor) == device_lengths
    _same(got, want)


def test_concat_batches_vs_jax():
    rng = np.random.default_rng(9)
    rbs = [pa.record_batch({
        "k": pa.array(rng.integers(0, 9, n)),
        "v": pa.array(rng.standard_normal(n),
                      mask=rng.random(n) < 0.2 if i else None),
    }) for i, n in enumerate([40, 7, 90])]
    want = jconcat.concat_batches(
        [at.Batch.from_pyarrow(rb, capacity=128) for rb in rbs])
    got = tconcat.concat_batches(
        [batch_from_pyarrow(rb, capacity=128, device="cpu") for rb in rbs])
    assert len(got) == len(want) == 137 and got.capacity == 384
    for i in range(2):
        _same(got.column(i), want.column(i))
    one = batch_from_pyarrow(rbs[0], device="cpu")
    assert tconcat.concat_batches([one]) is one


def test_concat_total_capacity_and_varlen():
    a = array_from_pyarrow(pa.array([1, 2, 3]), capacity=4, device="cpu")
    out = tconcat.concat_arrays([a, a], total_capacity=16)
    assert out.capacity == 16 and int(out.length) == 6
    assert out.values[:6].tolist() == [1, 2, 3, 1, 2, 3]
    s = array_from_pyarrow(pa.array(["ab", None, "", "cde"]), capacity=5,
                           device="cpu")
    out = tconcat.concat_arrays([s, s], total_capacity=16)
    assert out.capacity == 16 and int(out.length) == 8
    assert out.to_pylist() == ["ab", None, "", "cde"] * 2
