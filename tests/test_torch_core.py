"""Port parity: Array / Batch construction and the pyarrow boundary."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.interop import (array_from_pyarrow,
                                          array_to_pyarrow,
                                          batch_from_pyarrow, pad_capacity)


def _same(a, b):
    """Equal pyarrow arrays, NaN equal to NaN (pyarrow's equals says no)."""
    assert a.type == b.type
    np.testing.assert_array_equal(a.is_null().to_numpy(zero_copy_only=False),
                                  b.is_null().to_numpy(zero_copy_only=False))
    np.testing.assert_array_equal(a.to_numpy(zero_copy_only=False),
                                  b.to_numpy(zero_copy_only=False))


def _cols(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 16, n).astype(np.int64),
            "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(-100, 100, n).astype(np.int64),
            "f": rng.standard_normal(n),
            "b": rng.random(n) < 0.5,
            "u": rng.integers(0, 200, n).astype(np.uint8)}


def test_batch_from_numpy_matches_jax_batch():
    cols = _cols(777)
    jb = at.batch(cols)
    tb = att.batch_from_numpy(cols, device="cpu")
    assert str(tb.schema) == str(jb.schema)
    assert tb.capacity == jb.capacity == 777 and len(tb) == 777
    for name in cols:
        np.testing.assert_array_equal(tb.column(name).values.numpy(),
                                      np.asarray(jb.column(name).values))
        assert tb.column(name).validity is None
    assert tb.to_pyarrow().equals(jb.to_pyarrow())


def test_array_from_numpy_capacity_validity_and_constructors():
    vals = np.arange(10, dtype=np.int32)
    valid = np.arange(10) % 3 != 0
    a = att.array(vals, validity=valid, capacity=16, device="cpu")
    assert a.capacity == 16 and len(a) == 10
    assert a.type == dt.int32
    assert a.null_count() == 4
    np.testing.assert_array_equal(a.row_mask().numpy(), np.arange(16) < 10)
    np.testing.assert_array_equal(a.present_mask().numpy()[:10], valid)
    assert a.to_pylist() == [None if i % 3 == 0 else i for i in range(10)]
    with pytest.raises(ValueError):
        att.array(vals, capacity=5, device="cpu")
    assert att.nulls(3, dt.float32, device="cpu").to_pylist() == [None] * 3
    assert att.full(4, 7, dt.int64, capacity=8,
                    device="cpu").to_pylist() == [7] * 4
    # a device length (0-d tensor) works wherever an int does
    b = a.with_length(torch.tensor(5))
    assert len(b) == 5 and b.row_mask().sum().item() == 5


@pytest.mark.parametrize("pa_type,values", [
    (pa.int64(), [1, None, -3, 2 ** 40, None]),
    (pa.int32(), [None, 7, -7, 0, 1]),
    (pa.uint8(), [0, 255, None, 3, 4]),
    (pa.float32(), [1.5, None, float("nan"), -0.0, 3.25]),
    (pa.float64(), [None, 2.5, -1e300, 0.0, None]),
    (pa.bool_(), [True, None, False, True, None]),
])
def test_pyarrow_round_trip_with_nulls_vs_jax(pa_type, values):
    pa_arr = pa.array(values, type=pa_type)
    ta = array_from_pyarrow(pa_arr, device="cpu")
    ja = at.array(pa_arr)
    assert ta.capacity == ja.capacity == pad_capacity(len(values))
    _same(array_to_pyarrow(ta), ja.to_pyarrow())
    _same(ta.to_pyarrow(), pa_arr)
    # sliced input (non-zero offset) keeps its rows
    _same(array_from_pyarrow(pa_arr.slice(1, 3), device="cpu").to_pyarrow(),
          pa_arr.slice(1, 3))


def test_batch_pyarrow_round_trip_vs_jax():
    rng = np.random.default_rng(1)
    n = 300
    rb = pa.record_batch({
        "k": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.2),
        "v": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=rng.random(n) < 0.2),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
    })
    tb = batch_from_pyarrow(rb, device="cpu")
    jb = at.Batch.from_pyarrow(rb)
    assert tb.capacity == jb.capacity == 512
    assert tb.to_pyarrow().equals(jb.to_pyarrow())
    assert tb.to_pyarrow().equals(rb)
    assert att.Batch.from_pyarrow(pa.Table.from_batches([rb]), device="cpu") \
        .to_pyarrow().equals(rb)
    # batch() takes pyarrow, numpy and Arrays column by column
    mixed = att.batch({"k": rb["k"], "n": np.arange(n),
                       "a": tb["v"]}, capacity=512, device="cpu")
    assert mixed.capacity == 512 and len(mixed) == n
    assert mixed.to_pyarrow().column("k").equals(rb["k"])
    assert mixed.to_pyarrow().column("n").to_pylist() == list(range(n))


def test_batch_accessors_and_device_moves():
    tb = att.batch_from_numpy(_cols(40), device="cpu")
    assert tb.column_names == ("k", "v", "w", "f", "b", "u")
    assert tb["v"].type == dt.float32
    with pytest.raises(KeyError):
        tb.column("nope")
    nb = tb.set_column("k", att.array(np.ones(40, np.int32), device="cpu"))
    assert nb["k"].type == dt.int32 and nb.num_columns == 6
    nb = tb.set_column("z", att.array(np.ones(40, np.int32), device="cpu"))
    assert nb.column_names[-1] == "z"
    moved = tb.with_length(torch.tensor(10)).to("cpu")
    assert len(moved) == 10 and moved.device.type == "cpu"
    assert len(moved.to_pyarrow()) == 10
