"""Port parity of is_in / index_in and their ``_meta_binary`` forms
(``ops/set_lookup.py``) with the JAX package's, on the same pyarrow data
made from a seed, on the CPU, and against pyarrow: numbers, strings and
dictionaries, the three null behaviours, a value set cast to the input's
type, duplicates in the set (index of the first occurrence), and
``Expression.isin``. Exact."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.compute import call_function as jcall
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.compute.expressions import (execute_scalar_expression,
                                                 field)
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.ops.set_lookup import SetLookupOptions

from torch_parity import both, stage


def rand_numbers(seed, n, t, null_every=5):
    rng = np.random.default_rng(seed)
    v = rng.integers(0 if pa.types.is_unsigned_integer(t) else -3, 12, n)
    return pa.array([None if i % null_every == 1 else int(x)
                     for i, x in enumerate(v)], type=t)


@pytest.mark.parametrize("behavior", ["MATCH", "SKIP", "EMIT_NULL"])
@pytest.mark.parametrize("fn", ["is_in", "index_in"])
@pytest.mark.parametrize("t", [pa.int32(), pa.int64(), pa.uint64(),
                               pa.float64()], ids=str)
def test_numbers(t, fn, behavior):
    a = rand_numbers(1, 300, t)
    vs = pa.array([1, 5, 9, None, 5], type=t)
    got = both(fn, [a], capacity=512, value_set=vs,
               null_matching_behavior=behavior)
    if behavior != "EMIT_NULL":   # pyarrow 25 takes skip_nulls only
        want = getattr(pc, fn)(a, value_set=vs,
                               skip_nulls=behavior == "SKIP")
        assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("fn", ["is_in", "index_in"])
def test_value_set_cast_to_the_input(fn):
    a = rand_numbers(2, 100, pa.int32())
    vs = pa.array([1, 5, 9], type=pa.int64())
    got = both(fn, [a], value_set=vs)
    assert got.to_pylist() == getattr(pc, fn)(
        a, value_set=vs.cast(pa.int32())).to_pylist()


def test_index_in_first_occurrence():
    a = pa.array([5, 6, 7], type=pa.int64())
    vs = pa.array([6, 5, 5, 6], type=pa.int64())
    got = both("index_in", [a], value_set=vs)
    assert got.to_pylist() == pc.index_in(a, value_set=vs).to_pylist()


@pytest.mark.parametrize("fn", ["is_in", "index_in"])
@pytest.mark.parametrize("skip_nulls", [False, True])
def test_strings(fn, skip_nulls):
    rng = np.random.default_rng(3)
    words = np.array(["a", "zz", "", "bb", "ß", "long string past 16 B"])
    a = pa.array([None if i % 7 == 3 else words[j]
                  for i, j in enumerate(rng.integers(0, 6, 90))])
    vs = pa.array(["a", "", "long string past 16 B", "q"])
    got = both(fn, [a], capacity=128, value_set=vs, skip_nulls=skip_nulls)
    assert got.to_pylist() == getattr(pc, fn)(
        a, value_set=vs, skip_nulls=skip_nulls).to_pylist()


@pytest.mark.parametrize("fn", ["is_in", "index_in"])
def test_dictionary_probes_its_dictionary(fn):
    a = pa.array(["x", "y", "x", None, "z", "w"]).dictionary_encode()
    vs = pa.array(["x", "z"])
    got = both(fn, [a], value_set=vs)
    assert got.to_pylist() == getattr(pc, fn)(a, value_set=vs).to_pylist()


@pytest.mark.parametrize("fn", ["is_in_meta_binary", "index_in_meta_binary"])
def test_meta_binary(fn):
    a = rand_numbers(4, 60, pa.int64())
    vs = pa.array([2, 4, 6], pa.int64())
    t, j = stage(a, capacity=64)       # a scalar function's arguments
    tv, jv = stage(vs, capacity=64)    # share one capacity
    from torch_parity import assert_same
    got = tcall(fn, [t, tv])
    assert_same(got, jcall(fn, [j, jv]))
    plain = fn.replace("_meta_binary", "")
    assert got.to_pylist() == getattr(pc, plain)(a, value_set=vs).to_pylist()


def test_expression_isin_and_plain_lists():
    b = batch_from_numpy({"k": np.array([1, 2, 3, 4, 5]),
                          "s": np.array(["MAIL", "SHIP", "AIR", "MAIL",
                                         "RAIL"])}, device="cpu")
    assert execute_scalar_expression(field("k").isin([2, 5]),
                                     b).to_pylist() == \
        [False, True, False, False, True]
    assert execute_scalar_expression(field("s").isin(("MAIL", "SHIP")),
                                     b).to_pylist() == \
        [True, True, False, True, False]
    opts = SetLookupOptions(value_set=[1, None], skip_nulls=True)
    assert execute_scalar_expression(field("k").isin(opts),
                                     b).to_pylist() == \
        [True, False, False, False, False]
    with pytest.raises(ValueError, match="value_set"):
        tcall("is_in", [b.column("k")], options=SetLookupOptions())
