"""Port parity of the cumulative / pairwise / replace / fill-null /
indices_nonzero / scatter kernels (``ops/vector_misc.py``) with the JAX
package's, on the same pyarrow data made from a seed, on the CPU, and
against pyarrow. Integers, bools, validity and order are exact; float
cumulative sums and means are held to 1e-12·Σ|x| (float64) and
1e-5·Σ|x| + 1e-6 (float32): the port's scan may add in another order than
XLA's (on the card it does)."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.compute import call_function as jcall
from arrow_tpu_torch.compute import call_function as tcall

from torch_parity import assert_same, both, stage

CUM = ["cumulative_sum", "cumulative_prod", "cumulative_min",
       "cumulative_max"]
TYPES = ["int8", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
         "float32", "float64"]


def rand_array(seed, n, type_name, null_every=5, small=True):
    """``n`` values of the type (small ones for sums and products), one
    row in ``null_every`` null."""
    rng = np.random.default_rng(seed)
    t = getattr(pa, type_name)()
    if type_name.startswith("float"):
        v = rng.standard_normal(n) * 3
    elif type_name.startswith("uint"):
        v = rng.integers(0, 4 if small else 200, n)
    else:
        v = rng.integers(-3 if small else -100, 4 if small else 100, n)
    vals = [None if null_every and i % null_every == 2 else x.item()
            for i, x in enumerate(v.astype(t.to_pandas_dtype()))]
    return pa.array(vals, type=t)


def _cum_tolerance(fn, arr):
    """(rtol, scale) of a float cumulative result, or (None, None): sums
    to 1e-12·Σ|x| (float64) and 1e-5·Σ|x| + 1e-6 (float32), the running
    sum of |x| as the scale; products to 1e-12 (float64) and 1e-5
    (float32) of their own magnitude; min and max exact."""
    if not pa.types.is_floating(arr.type) or fn in ("cumulative_min",
                                                    "cumulative_max"):
        return None, None
    f32 = arr.type == pa.float32()
    rtol = 1e-5 if f32 else 1e-12
    if fn == "cumulative_prod":
        return rtol, None
    x = np.abs(np.nan_to_num(arr.to_numpy(zero_copy_only=False)
                             .astype(np.float64)))
    scale = np.cumsum(x)
    return rtol, scale + 0.1 if f32 else scale


@pytest.mark.parametrize("skip_nulls", [False, True])
@pytest.mark.parametrize("t", TYPES)
@pytest.mark.parametrize("fn", CUM)
def test_cumulative(fn, t, skip_nulls):
    a = rand_array(1, 137, t)
    ta, ja = stage(a, capacity=160)
    got = tcall(fn, [ta], skip_nulls=skip_nulls)
    want = jcall(fn, [ja], skip_nulls=skip_nulls)
    rtol, scale = _cum_tolerance(fn, a)
    assert_same(got, want, rtol=rtol, scale=scale)
    if not t.startswith("float"):
        assert got.to_pylist() == getattr(pc, fn)(
            a, skip_nulls=skip_nulls).to_pylist()


@pytest.mark.parametrize("fn,start", [("cumulative_sum", 10),
                                      ("cumulative_prod", 3),
                                      ("cumulative_min", 2),
                                      ("cumulative_max", 3)])
@pytest.mark.parametrize("t", ["int64", "uint64", "float64"])
def test_cumulative_start(fn, start, t):
    a = pa.array([1, 2, None, 4, 0, 5], type=getattr(pa, t)())
    got = both(fn, [a], start=start, skip_nulls=True)
    assert got.to_pylist() == getattr(pc, fn)(
        a, start=start, skip_nulls=True).to_pylist()


def test_cumulative_float_identities_are_arrows():
    """Arrow's quirk, copied from the JAX package: a float cumulative
    max's identity is the smallest positive normal (numeric_limits::min),
    not -inf, so a null row skipped over negative values carries it on
    (pyarrow's own kernel starts from it: [tiny, null, tiny] here)."""
    a = pa.array([-5.0, None, -2.0], pa.float64())
    got = both("cumulative_max", [a], skip_nulls=True)
    tiny = np.finfo(np.float64).tiny
    assert got.to_pylist() == [-5.0, None, tiny]
    assert pc.cumulative_max(a, skip_nulls=True).to_pylist() == \
        [tiny, None, tiny]


@pytest.mark.parametrize("skip_nulls", [False, True])
@pytest.mark.parametrize("t", ["int64", "float32"])
def test_cumulative_mean(t, skip_nulls):
    a = rand_array(2, 100, t, null_every=4)
    ta, ja = stage(a)
    got = tcall("cumulative_mean", [ta], skip_nulls=skip_nulls)
    want = jcall("cumulative_mean", [ja], skip_nulls=skip_nulls)
    assert_same(got, want, rtol=1e-12)
    exp = pc.cumulative_mean(a, skip_nulls=skip_nulls).to_pylist()
    for g, e in zip(got.to_pylist(), exp):
        assert (g is None and e is None) or abs(g - e) <= 1e-12 * abs(e)


@pytest.mark.parametrize("period", [1, 2, -1, 5])
@pytest.mark.parametrize("t", ["int8", "int64", "uint8", "uint32",
                               "float64"])
def test_pairwise_diff(period, t):
    a = rand_array(3, 90, t, small=False)
    got = both("pairwise_diff", [a], capacity=128, period=period)
    if t in ("int64", "float64"):
        assert got.to_pylist() == pc.pairwise_diff(
            a, period=period).to_pylist()


def test_replace_with_mask():
    a = pa.array([1, 2, None, 4, 5, 6], pa.int64())
    m = pa.array([True, False, True, None, True, False])
    r = pa.array([10, None, 30], pa.int64())
    got = both("replace_with_mask", [a, m, r], capacity=8)
    assert got.to_pylist() == pc.replace_with_mask(a, m, r).to_pylist()
    rf = pa.array([1.5, 2.5, 3.5])
    both("replace_with_mask", [pa.array([1.0, 2.0, 3.0]),
                               pa.array([True, True, True]), rf])


def test_replace_with_mask_scalar():
    from arrow_tpu.compute.scalar import scalar as jscalar
    from arrow_tpu_torch.compute.scalar import scalar as tscalar
    a = pa.array([1, None, 3, 4], pa.int32())
    m = pa.array([False, True, True, None])
    ta, ja = stage(a)
    tm, jm = stage(m)
    for v in (99, None):
        got = tcall("replace_with_mask", [ta, tm, tscalar(v, ta.type)])
        import arrow_tpu.core.datatype as jdt
        want = jcall("replace_with_mask", [ja, jm, jscalar(v, jdt.int32)])
        assert_same(got, want)


@pytest.mark.parametrize("fn", ["fill_null_forward", "fill_null_backward"])
@pytest.mark.parametrize("t", ["int64", "float32", "uint16", "bool"])
def test_fill_null_directional(fn, t):
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 50, 80)
    nulls = rng.random(80) < 0.4
    nulls[:3] = True
    nulls[-3:] = True
    a = pa.array([None if z else (bool(v % 2) if t == "bool" else int(v))
                  for v, z in zip(vals, nulls)], type=pa.bool_() if t == "bool" else getattr(pa, t)())
    got = both(fn, [a], capacity=96)
    assert got.to_pylist() == getattr(pc, fn)(a).to_pylist()


def test_fill_null_strings():
    a = pa.array([None, "ab", None, None, "cde", None])
    t, _ = stage(a)
    for fn in ("fill_null_forward", "fill_null_backward"):
        assert tcall(fn, [t]).to_pylist() == getattr(pc, fn)(a).to_pylist()


@pytest.mark.parametrize("t", ["int32", "float64", "bool", "uint64"])
def test_indices_nonzero(t):
    vals = [0, 3, None, 0, -1, 7, None, 0, 1] if t in ("int32", "float64") \
        else [0, 3, None, 0, 1, 7, None, 0, 1]
    if t == "bool":
        vals = [v if v is None else v != 0 for v in vals]
    a = pa.array(vals, type=pa.bool_() if t == "bool" else getattr(pa, t)())
    got = both("indices_nonzero", [a], capacity=16)
    assert got.to_pylist() == pc.indices_nonzero(a).to_pylist()


@pytest.mark.parametrize("max_index", [-1, 5, 40])
def test_scatter(max_index):
    from arrow_tpu.ops.vector_misc import ScatterOptions as JScatter
    from arrow_tpu_torch.ops.vector_misc import ScatterOptions as TScatter
    values = pa.array([10, 20, None, 40], pa.int64())
    idx = pa.array([3, 0, 1, 4], pa.int32())
    both("scatter", [values, idx], options=TScatter(max_index),
         jax_options=JScatter(max_index))
