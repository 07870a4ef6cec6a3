"""Port parity: ``ops/aggregates_order`` (min_max, first, last,
first_last, index, count_distinct, quantile, tdigest, approximate_median,
mode, skew, kurtosis, winsorize) and ``ops/vector_hash`` (unique,
value_counts, dictionary_encode, dictionary_decode) against the JAX
package on the same pyarrow inputs made from a seed with numpy.

Integers, bools, strings, quantiles and counts exact; float64 results
within 1e-9 relative.
"""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu import compute as jc
from arrow_tpu.ops import aggregates_order as jorder
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.core.interop import array_from_pyarrow
from arrow_tpu_torch.ops import aggregates_order as torder

F64_RTOL = 1e-9

_TYPES = {"int32": pa.int32(), "int64": pa.int64(), "uint16": pa.uint16(),
          "uint32": pa.uint32(), "uint64": pa.uint64(), "float32": pa.float32(),
          "float64": pa.float64(), "bool": pa.bool_()}


def _array(seed, t, n=301, null_prob=0.2, small=False):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < null_prob
    if pa.types.is_boolean(t):
        vals = rng.random(n) < 0.5
    elif pa.types.is_floating(t):
        vals = rng.standard_normal(n) * 10
        if small:
            vals = np.round(vals)
    elif pa.types.is_unsigned_integer(t):
        vals = rng.integers(0, 30 if small else 1 << (t.bit_width - 1), n,
                            dtype=np.uint64)
    else:
        vals = rng.integers(-15 if small else -(1 << 20),
                            15 if small else 1 << 20, n)
    return pa.array(vals, type=t, mask=mask)


def _both(pa_arr):
    return at.array(pa_arr), array_from_pyarrow(pa_arr, device="cpu")


def _py(x):
    """A result as Python values: Scalars by ``as_py``, Arrays and Batches
    through pyarrow."""
    if hasattr(x, "as_py"):
        return x.as_py()
    pa_x = x.to_pyarrow()
    return pa_x.to_pylist() if hasattr(pa_x, "to_pylist") else pa_x


def _same(got, want):
    if isinstance(want, float) and isinstance(got, float):
        assert (got != got and want != want) or \
            got == pytest.approx(want, rel=F64_RTOL, abs=1e-300)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _same(got[key], want[key])
    else:
        assert got == want


def _call_both(fn, pa_arr, jopts=None, topts=None, **kw):
    ja, ta = _both(pa_arr)
    want = jc.call_function(fn, [ja], options=jopts, **kw)
    got = tc.call_function(fn, [ta], options=topts, **kw)
    return _py(got), _py(want)


# uint64 min_max overflows its identity in the JAX package (jnp.iinfo)
@pytest.mark.parametrize("null_prob", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("t", [t for t in _TYPES if t != "uint64"])
@pytest.mark.parametrize("fn", ["min_max", "first", "last", "first_last"])
def test_edges_vs_jax(fn, t, null_prob):
    got, want = _call_both(fn, _array(len(fn) + len(t), _TYPES[t],
                                      null_prob=null_prob))
    _same(got, want)


@pytest.mark.parametrize("t", ["int64", "float64", "bool"])
def test_index_vs_jax(t):
    a = _array(3, _TYPES[t], small=True)
    value = True if t == "bool" else 3
    got, want = _call_both("index", a, jorder.IndexOptions(value),
                           torder.IndexOptions(value))
    assert got == want
    got, want = _call_both("index", a, jorder.IndexOptions(False if t ==
                                                           "bool" else 999),
                           torder.IndexOptions(False if t == "bool" else 999))
    assert got == want


@pytest.mark.parametrize("mode", ["only_valid", "all"])
@pytest.mark.parametrize("t", ["int32", "uint64", "float64", "bool",
                               "string"])
def test_count_distinct_vs_jax(t, mode):
    if t == "string":
        rng = np.random.default_rng(4)
        a = pa.array([f"s{x}" for x in rng.integers(0, 40, 300)],
                     mask=rng.random(300) < 0.2)
    else:
        a = _array(5, _TYPES[t], small=True)
    got, want = _call_both("count_distinct", a, mode=mode)
    assert got == want


@pytest.mark.parametrize("interp", ["linear", "lower", "higher", "nearest",
                                    "midpoint"])
@pytest.mark.parametrize("t", ["int64", "float32", "float64"])
def test_quantile_vs_jax(t, interp):
    a = _array(7, _TYPES[t])
    q = [0.0, 0.1, 0.5, 0.77, 1.0]
    got, want = _call_both(
        "quantile", a, jorder.QuantileOptions(q, interpolation=interp),
        torder.QuantileOptions(q, interpolation=interp))
    _same(got, want)


@pytest.mark.parametrize("fn", ["tdigest", "approximate_median"])
@pytest.mark.parametrize("null_prob", [0.0, 0.3, 1.0])
def test_tdigest_median_vs_jax(fn, null_prob):
    a = _array(9, pa.float64(), null_prob=null_prob)
    if fn == "tdigest":
        got, want = _call_both(fn, a, jorder.TDigestOptions([0.25, 0.5]),
                               torder.TDigestOptions([0.25, 0.5]))
    else:
        got, want = _call_both(fn, a)
    _same(got, want)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("t", ["int32", "float64", "bool"])
def test_mode_vs_jax(t, n):
    got, want = _call_both("mode", _array(11, _TYPES[t], small=True),
                           jorder.ModeOptions(n), torder.ModeOptions(n))
    assert got == want


@pytest.mark.parametrize("biased", [True, False])
@pytest.mark.parametrize("fn", ["skew", "kurtosis"])
@pytest.mark.parametrize("t", ["int64", "float64"])
def test_skew_kurtosis_vs_jax(t, fn, biased):
    got, want = _call_both(fn, _array(13, _TYPES[t]),
                           jorder.SkewOptions(biased=biased),
                           torder.SkewOptions(biased=biased))
    _same(got, want)


def test_skew_centres_the_values():
    """The scalar skew / kurtosis centre the values on their mean before
    the powers (``_central_moments``): at an offset of 1e9 they are numpy's
    (to the offset's spacing), as the JAX package's are."""
    rng = np.random.default_rng(15)
    v = rng.standard_normal(5000) + 1e9
    d = v - v.mean()
    for fn, want in (("skew", (d ** 3).mean() / (d ** 2).mean() ** 1.5),
                     ("kurtosis", (d ** 4).mean() / (d ** 2).mean() ** 2
                      - 3.0)):
        got, jax_got = _call_both(fn, pa.array(v))
        assert abs(got - want) <= 16 * np.spacing(1e9)
        assert abs(jax_got - want) <= 16 * np.spacing(1e9)


@pytest.mark.parametrize("limits", [(0.1, 0.9), (0.0, 0.5)])
@pytest.mark.parametrize("t", ["int32", "float64"])
def test_winsorize_vs_jax(t, limits):
    got, want = _call_both("winsorize", _array(17, _TYPES[t]),
                           jorder.WinsorizeOptions(*limits),
                           torder.WinsorizeOptions(*limits))
    _same(got, want)


# ---- vector_hash ---------------------------------------------------------------

def _strings(seed, n=200):
    rng = np.random.default_rng(seed)
    return pa.array([f"w{x}" * (1 + x % 5) for x in rng.integers(0, 30, n)],
                    mask=rng.random(n) < 0.15)


@pytest.mark.parametrize("fn", ["unique", "value_counts",
                                "dictionary_encode"])
@pytest.mark.parametrize("t", ["int64", "uint16", "float32", "bool",
                               "string"])
def test_vector_hash_vs_jax(fn, t):
    a = _strings(19) if t == "string" else _array(19, _TYPES[t], small=True)
    ja, ta = _both(a)
    want = jc.call_function(fn, [ja])
    got = tc.call_function(fn, [ta])
    if fn == "dictionary_encode":
        assert _py(got) == _py(want)
        assert got.dictionary.to_pyarrow().to_pylist() == \
            want.dictionary.to_pyarrow().to_pylist()
        back = tc.call_function("dictionary_decode", [got])
        assert _py(back) == a.to_pylist()
    else:
        _same(_py(got) if fn == "unique" else got.to_pyarrow().to_pydict(),
              _py(want) if fn == "unique" else
              want.to_pyarrow().to_pydict())


def test_dictionary_decode_of_a_dictionary_column():
    a = pa.array(["x", "y", None, "x", "z"]).dictionary_encode()
    ta = array_from_pyarrow(a, device="cpu")
    got = tc.call_function("dictionary_decode", [ta])
    assert _py(got) == ["x", "y", None, "x", "z"]
    assert tc.call_function("dictionary_encode", [ta]) is ta


@pytest.mark.parametrize("fn", ["min_max", "first_last"])
def test_uint64_edges_vs_pyarrow(fn):
    """uint64 past 2^63, where the JAX package's min_max overflows its
    identity: the port's min_max and first_last are pyarrow's."""
    import pyarrow.compute as pc
    rng = np.random.default_rng(21)
    a = pa.array(rng.integers(0, 1 << 64, 200, dtype=np.uint64),
                 mask=rng.random(200) < 0.2)
    got = tc.call_function(fn, [array_from_pyarrow(a, device="cpu")])
    assert got.as_py() == getattr(pc, fn)(a).as_py()
