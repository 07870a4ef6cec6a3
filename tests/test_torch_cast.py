"""Port parity of the cast kernel (``ops/scalar_cast.py``) with the JAX
package's, on the same pyarrow data made from a seed, on the CPU: every
numeric / bool pair, every temporal pair, the string casts both ways,
dictionary decode and encode, and the ``Table`` / ``compute`` /
``Expression`` forms. Exact: validity, values bit for bit, offsets and
bytes; string -> float within 2 ulp (the JAX package's own multi-step
float math, torch's ``pow`` against XLA's).

Where the port does not copy a fault of the JAX package (ROADMAP C29 (b):
``allow_overflow=False`` is ignored; C29 (d): uint64 values from 2^63 up
print as negative numbers), it is held against pyarrow and the JAX
package's difference is kept on record. float -> integer saturates as XLA
does, on either device (the card's half is ``tests/test_torch_a7b_cuda.py``).
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.core import datatype as jdt
from arrow_tpu.ops.scalar_cast import CastOptions as JCast
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.compute.expressions import (execute_scalar_expression,
                                                 field)
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.core.schema import Field, Schema
from arrow_tpu_torch.ops.scalar_cast import CastOptions as TCast
from arrow_tpu_torch.utils.errors import ArrowInvalid

from torch_parity import both, stage

NUMERIC = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
           "uint64", "float16", "float32", "float64", "bool_"]
FLOAT_SPECIALS = [np.nan, np.inf, -np.inf, 3e10, -3e10, -2.9, 2.9, 1e19,
                  2.0 ** 63, 2.0 ** 64, -0.5, 255.9, 300.0, -129.5, 65504.0]


def _with_nulls(values, pa_type, every=7):
    vals = list(values)
    for i in range(3, len(vals), every):
        vals[i] = None
    return pa.array(vals, type=pa_type)


def numeric_data(name, seed=0, n=60):
    t = getattr(tdt, name)
    rng = np.random.default_rng(seed)
    if name == "bool_":
        return _with_nulls(rng.random(n) < 0.5, pa.bool_())
    if name.startswith("float"):
        v = np.concatenate([rng.standard_normal(n) * 10.0 **
                            rng.integers(-3, 12, n), FLOAT_SPECIALS])
        with np.errstate(over="ignore"):
            v = v.astype(t.storage_np)
    else:
        info = np.iinfo(t.storage_np)
        v = np.concatenate([rng.integers(info.min, info.max, n,
                                         dtype=t.storage_np, endpoint=True),
                            np.array([info.min, info.max, 0, 1],
                                     dtype=t.storage_np)])
    return _with_nulls(v.tolist(), tdt.to_pyarrow_type(t))


def cast_both(arr, name_or_types, capacity=None):
    tt, jt = name_or_types if isinstance(name_or_types, tuple) else \
        (getattr(tdt, name_or_types), getattr(jdt, name_or_types))
    return both("cast", [arr], capacity=capacity, options=TCast(tt),
                jax_options=JCast(jt))


@pytest.mark.parametrize("dst", NUMERIC)
@pytest.mark.parametrize("src", NUMERIC)
def test_cast_numeric_pair(src, dst):
    cast_both(numeric_data(src), dst, capacity=128)


@pytest.mark.parametrize("dst,want", [
    ("int32", [0, 2147483647, -2147483648, 2147483647, -2, 0]),
    ("uint8", [0, 255, 0, 255, 0, 0]),
    ("int64", [0, 9223372036854775807, -9223372036854775808,
               30000000000, -2, 0])])
def test_float_to_int_saturates(dst, want):
    """float64 [NaN, inf, -inf, 3e10, -2.9, -0.5] saturates as XLA's
    convert does (torch's ``.to()`` gives other values)."""
    arr = pa.array([np.nan, np.inf, -np.inf, 3e10, -2.9, -0.5])
    got = cast_both(arr, dst)
    assert got.values[:6].tolist() == want


TEMPORAL = [("timestamp", "s"), ("timestamp", "ms"), ("timestamp", "us"),
            ("timestamp", "ns"), ("date32", None), ("date64", None),
            ("time32", "s"), ("time32", "ms"), ("time64", "us"),
            ("time64", "ns"), ("duration", "s"), ("duration", "ms"),
            ("duration", "us"), ("duration", "ns")]


def _ttype(mod, kind, unit):
    t = getattr(mod, kind)
    return t(unit) if unit else t


def temporal_data(kind, unit, seed=1, n=50):
    """Values of a temporal type from the seed, pre-epoch instants
    included; times of day in [0, 1 day)."""
    rng = np.random.default_rng(seed)
    per_s = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}.get(unit, 1)
    if kind.startswith("time"):
        v = rng.integers(0, 86_400 * per_s, n)
    elif kind == "date32":
        v = rng.integers(-40_000, 40_000, n)
    elif kind == "date64":
        v = rng.integers(-40_000, 40_000, n) * 86_400_000 + \
            rng.integers(-10**7, 10**7, n)
    else:
        v = rng.integers(-3 * 10**9, 3 * 10**9, n) * per_s + \
            rng.integers(0, per_s, n)
    v[:4] = [-1500 if per_s > 1 else -1, 0, 1, -per_s]
    t = _ttype(tdt, kind, unit)
    storage = pa.from_numpy_dtype(t.storage_np)
    return _with_nulls(v.astype(t.storage_np).tolist(), storage).cast(
        tdt.to_pyarrow_type(t))


@pytest.mark.parametrize("dst", TEMPORAL, ids=lambda k: "-".join(
    x for x in k if x))
@pytest.mark.parametrize("src", TEMPORAL, ids=lambda k: "-".join(
    x for x in k if x))
def test_cast_temporal_pair(src, dst):
    cast_both(temporal_data(*src),
              (_ttype(tdt, *dst), _ttype(jdt, *dst)), capacity=64)


@pytest.mark.parametrize("kind", [("timestamp", "us"), ("date32", None),
                                  ("duration", "ms"), ("time32", "s")])
def test_cast_temporal_int64_both_ways(kind):
    a = temporal_data(*kind)
    out = cast_both(a, "int64")
    cast_both(out.to_pyarrow(), (_ttype(tdt, *kind), _ttype(jdt, *kind)))


@pytest.mark.parametrize("src", ["int8", "int16", "int32", "int64",
                                 "uint8", "uint16", "uint32"])
def test_int_to_string(src):
    got = cast_both(numeric_data(src, seed=2), "string", capacity=128)
    arr = numeric_data(src, seed=2)
    assert got.to_pylist() == arr.cast(pa.string()).to_pylist()


def test_uint64_to_string_c29d():
    """C29 (d): the port prints a uint64 as pyarrow does; the JAX package
    reads it as int64, so 2^63 and up print negative."""
    from arrow_tpu.compute import call_function as jcall
    arr = pa.array([2**64 - 1, 2**63, 5, None, 0], pa.uint64())
    t, j = stage(arr)
    got = tc.call_function("cast", [t], options=TCast(tdt.string))
    assert got.to_pylist() == arr.cast(pa.string()).to_pylist()
    jax_out = jcall("cast", [j], options=JCast(jdt.string)).to_pylist()
    assert jax_out == ["-1", "-9223372036854775808", "5", None, "0"]


@pytest.mark.parametrize("src", ["float16", "float32", "float64"])
def test_float_to_string(src):
    cast_both(numeric_data(src, seed=3), "string", capacity=128)


def test_bool_string_both_ways():
    got = cast_both(numeric_data("bool_", seed=4), "string", capacity=128)
    assert got.to_pylist() == numeric_data("bool_", seed=4).cast(
        pa.string()).to_pylist()
    words = pa.array(["true", "FALSE", "1", "0", "yes", "", None, "True",
                      "falsey", "false"])
    cast_both(words, "bool_", capacity=16)


INT_STRINGS = ["123", "-45", "+7", "", "abc", "12a", "-", "0",
               "9223372036854775807", "-9223372036854775808",
               "99999999999999999999", "300", None, "007", "1 2", "255"]


@pytest.mark.parametrize("dst", ["int8", "int16", "int32", "int64",
                                 "uint8", "uint32", "uint64"])
def test_string_to_int(dst):
    cast_both(pa.array(INT_STRINGS), dst, capacity=32)


FLOAT_STRINGS = ["1.5", "-2.25e3", "3e-4", ".5", "5.", "inf", "-inf",
                 "NaN", "1e", "x", "", None, "1.2.3", "-0.0", "123456789",
                 "6.02214076E23", "+12.5", "1e-300", "2.5e+10"]


@pytest.mark.parametrize("dst", ["float32", "float64"])
def test_string_to_float(dst):
    from arrow_tpu.compute import call_function as jcall
    arr = pa.array(FLOAT_STRINGS)
    t, j = stage(arr, capacity=32)
    got = tc.call_function("cast", [t], options=TCast(getattr(tdt, dst)))
    want = jcall("cast", [j], options=JCast(getattr(jdt, dst)))
    from torch_parity import assert_same
    assert_same(got, want, ulps=2)


@pytest.mark.parametrize("dst", [("timestamp", "s"), ("timestamp", "ms"),
                                 ("timestamp", "us"), ("timestamp", "ns"),
                                 ("date32", None), ("date64", None)],
                         ids=lambda k: "-".join(x for x in k if x))
def test_string_to_temporal(dst):
    arr = pa.array(["2024-02-29", "1969-12-31T23:59:59.5", None,
                    "1900-01-01 12:00:00", "2024-02-29", "2100-12-31T00:00",
                    "1970-01-01"])
    cast_both(arr, (_ttype(tdt, *dst), _ttype(jdt, *dst)), capacity=16)


def test_string_to_temporal_raises_like_jax():
    t, _ = stage(pa.array(["2024-01-01", "not a date"]))
    with pytest.raises(ValueError, match="cannot parse 'not a date'"):
        tc.call_function("cast", [t], options=TCast(tdt.date32))


@pytest.mark.parametrize("src", [("timestamp", "s"), ("timestamp", "us"),
                                 ("timestamp", "ns"), ("date32", None),
                                 ("date64", None)],
                         ids=lambda k: "-".join(x for x in k if x))
def test_temporal_to_string(src):
    cast_both(temporal_data(*src, seed=5), "string", capacity=64)


def test_dictionary_decode_and_encode():
    d = pa.array(["b", "a", None, "b", "c"]).dictionary_encode()
    got = cast_both(d, "string", capacity=16)
    assert got.to_pylist() == d.cast(pa.string()).to_pylist()
    ints = pa.array([3, 1, None, 3, 7], pa.int64())
    out = tc.call_function(
        "cast", [stage(ints)[0]],
        options=TCast(tdt.dictionary(tdt.int32, tdt.int64)))
    assert out.to_pyarrow().to_pylist() == ints.to_pylist()
    assert out.dictionary.to_pylist() == [3, 1, 7]


def test_checked_narrowing_cast_raises_c29b():
    """C29 (b): a narrowing cast that does not fit raises with
    ``allow_overflow=False``, as pyarrow's safe cast does; the default
    wraps in both packages; the JAX package ignores the flag."""
    from arrow_tpu.compute import call_function as jcall
    arr = pa.array([300, -200, 5], pa.int64())
    t, j = stage(arr)
    with pytest.raises(pa.ArrowInvalid):
        arr.cast(pa.int8())
    with pytest.raises(ArrowInvalid, match="cast int64 -> int8"):
        tc.call_function("cast", [t], options=TCast(tdt.int8, False))
    wrapped = [44, 56, 5]
    assert tc.cast(t, tdt.int8).to_pylist() == wrapped
    assert jcall("cast", [j], options=JCast(jdt.int8, False)
                 ).to_pylist() == wrapped
    # values that fit pass, floats are range-checked too
    ok = stage(pa.array([100, -100, None], pa.int64()))[0]
    assert tc.cast(ok, tdt.int8, allow_overflow=False).to_pylist() == \
        [100, -100, None]
    with pytest.raises(ArrowInvalid):
        tc.cast(stage(pa.array([1.0, np.nan]))[0], tdt.int32,
                allow_overflow=False)
    with pytest.raises(ArrowInvalid):
        tc.cast(stage(pa.array([2**63], pa.uint64()))[0], tdt.int64,
                allow_overflow=False)


def test_table_compute_and_expression_cast():
    pt = pa.table({"a": pa.array([1, None, 3], pa.int64()),
                   "b": pa.array([1.5, 2.5, None])})
    t = Table.from_pyarrow(pt, device="cpu")
    schema = Schema((Field("a", tdt.float64, True),
                     Field("b", tdt.int32, True)))
    got = t.cast(schema).to_pyarrow()
    target = pa.schema([("a", pa.float64()), ("b", pa.int32())])
    assert got.to_pylist() == pt.cast(target, safe=False).to_pylist()
    widen = pa.schema([("a", pa.float64()), ("b", pa.float32())])
    assert t.cast(widen).to_pyarrow().equals(pt.cast(widen))
    b = t.batches[0]
    out = execute_scalar_expression(field("a").cast(tdt.string), b)
    assert out.to_pylist() == ["1", None, "3"]
    assert tc.cast(b.column("b"), tdt.int64).to_pylist() == [1, 2, None]
    assert pc.cast(pt["b"], pa.int64(), safe=False).to_pylist() == \
        [1, 2, None]


def test_registers_the_a7b_functions():
    """Every function the JAX package's scalar_cast, temporal,
    scalar_checked, vector_misc and set_lookup modules register (83) is
    registered in the port, by the port's module of the same name."""
    from arrow_tpu.compute.registry import registry as jregistry
    from arrow_tpu_torch.compute.registry import registry as tregistry
    mods = ("scalar_cast", "temporal", "scalar_checked", "vector_misc",
            "set_lookup")
    jax_names = {n for n in jregistry.list_functions()
                 if jregistry.get(n).exec.__module__.rsplit(".", 1)[-1]
                 in mods}
    assert len(jax_names) == 83
    for n in jax_names:
        fn = tregistry.get(n)
        assert fn.exec.__module__ == "arrow_tpu_torch.ops." + \
            jregistry.get(n).exec.__module__.rsplit(".", 1)[-1], n
        assert fn.kind.name == jregistry.get(n).kind.name
        assert fn.arity == jregistry.get(n).arity
