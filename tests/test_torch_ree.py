"""Port parity of ``ops/ree``: run-end encode (its run ends through
``get_take_indices``, the two-level compaction's plain versions on the
CPU), decode, the take of a run-end-encoded column, and ``random``; against
pyarrow and the JAX package's buffers on the same input. Run-end-encoded
columns have no pyarrow interop in either package (``to_pyarrow_type``
raises), so run ends and values are compared as buffers, as the JAX
package's own ``tests/test_ree.py`` does.

Not a fault, on record: the JAX ``random`` draws from ``jax.random``, the
port's from a ``torch.Generator``: values differ between the packages (and
between the CPU and the card); the range, type and determinism for one
initializer hold in both.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu import compute as jc
from arrow_tpu.core import interop as jinterop
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.ops import selection as tsel
from arrow_tpu_torch.ops.ree import run_end_decode_array, \
    run_end_encode_array
from torch_parity import valid_of


def _stage(arr):
    return (tinterop.array_from_pyarrow(arr, device="cpu"),
            jinterop.array_from_pyarrow(arr))


def _runs(rng, n, dtype, nulls):
    base = rng.integers(0, 4, n)
    vals = np.repeat(base, rng.integers(1, 5, n))[:n]
    mask = None
    if nulls:
        mask = np.repeat(rng.random(n) < 0.2, rng.integers(1, 4, n))[:n]
    return pa.array(vals.astype(dtype.to_pandas_dtype()), dtype, mask=mask)


@pytest.mark.parametrize("dtype", [pa.int64(), pa.int32(), pa.uint64(),
                                   pa.float64(), pa.bool_()])
@pytest.mark.parametrize("nulls", [False, True])
def test_encode_decode_match_pyarrow_and_jax(dtype, nulls):
    a = _runs(np.random.default_rng(11), 700, dtype, nulls)
    t, j = _stage(a)
    got = tc.call_function("run_end_encode", [t])
    want = jc.call_function("run_end_encode", [j])
    exp = pc.run_end_encode(a)
    n = len(got)
    assert n == len(exp.run_ends) == int(want.length)
    ends = got.offsets[1:n + 1].numpy()
    assert ends.tolist() == exp.run_ends.to_pylist()
    np.testing.assert_array_equal(got.offsets.numpy(),
                                  np.asarray(want.offsets))
    ok = valid_of(got.validity, n)
    np.testing.assert_array_equal(ok, valid_of(want.validity, n))
    vals = got.values[:n].numpy()
    np.testing.assert_array_equal(vals[ok], np.asarray(want.values)[:n][ok])
    assert [x if v else None for x, v in zip(vals.tolist(), ok)] == \
        exp.values.to_pylist()
    back = tc.call_function("run_end_decode", [got])
    assert back.to_pyarrow().equals(a)
    assert back.to_pylist() == jc.call_function(
        "run_end_decode", [want]).to_pylist()


def test_null_rows_with_other_slots_are_other_runs():
    """As pyarrow has it: null rows whose value slots differ are separate
    runs (and null rows with equal slots one run)."""
    a = pa.array(np.array([1, 5, 6, 6, 2]),
                 mask=np.array([False, True, True, True, False]))
    t, _ = _stage(a)
    enc = run_end_encode_array(t)
    assert enc.offsets[1:len(enc) + 1].tolist() == \
        pc.run_end_encode(a).run_ends.to_pylist() == [1, 2, 4, 5]


def test_take_of_a_ree_column_keeps_its_type():
    a = _runs(np.random.default_rng(4), 64, pa.int64(), True)
    t, _ = _stage(a)
    enc = run_end_encode_array(t, run_end_type=dt.int32)
    idx, _ = _stage(pa.array([5, 5, 0, 63, 17], pa.int32()))
    out = tsel.take_array(enc, idx)
    assert isinstance(out.type, dt.RunEndEncodedType)
    assert run_end_decode_array(out).to_pylist() == \
        a.take(pa.array([5, 5, 0, 63, 17])).to_pylist()


def test_encode_refuses_varlen_and_interop_raises():
    t, _ = _stage(pa.array(["a", "a"]))
    with pytest.raises(NotImplementedError):
        run_end_encode_array(t)
    enc = run_end_encode_array(_stage(pa.array([1, 1, 2]))[0])
    with pytest.raises(NotImplementedError):
        enc.to_pyarrow()
    with pytest.raises(NotImplementedError):
        tinterop.array_from_pyarrow(pc.run_end_encode(pa.array([1, 1])),
                                    device="cpu")


def test_random_range_type_and_determinism():
    r = tc.call_function("random", [], length=1000, initializer=7,
                         device="cpu")
    vals = r.values.numpy()
    assert r.type == dt.float64 and len(r) == 1000
    assert ((vals >= 0.0) & (vals < 1.0)).all()
    again = tc.call_function("random", [], length=1000, initializer=7,
                             device="cpu")
    np.testing.assert_array_equal(vals, again.values.numpy())
    other = tc.call_function("random", [], length=1000, initializer=8,
                             device="cpu")
    assert not np.array_equal(vals, other.values.numpy())
    with pytest.raises(ValueError):
        tc.call_function("random", [], length=0, device="cpu")
    # the JAX package draws other values from its own generator
    jvals = np.asarray(jc.call_function("random", [], length=1000,
                                        initializer=7).values)
    assert ((jvals >= 0.0) & (jvals < 1.0)).all()
