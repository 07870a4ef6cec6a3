"""Port parity: the wider column types (ROADMAP A10) against the JAX
package on the CPU: decimal128 / decimal256 (precision up to 18 one int64
lane, past it two int64 limbs [low, high signed]), fixed_size_binary
((cap, w) bytes) and the month_day_nano / day_time intervals (struct
layout). They stage both ways; decimals compare, group, sort, hash, join,
filter and take as in the JAX package; fixed-size binary stages, takes and
filters, and raises as a key in both packages. All exact.

Two JAX differences are kept on record: a decimal compared with a decimal
scalar (the JAX package reads the scalar unscaled: ``equal(12.34,
12.34)`` is false, and a wide one raises), where the port follows pyarrow;
and a join whose string columns fan out past their pool (ROADMAP C31, in
``test_torch_repairs_c31_c33.py``)."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import call_function as jcall
from arrow_tpu.compute.scalar import Scalar as JScalar
from arrow_tpu.ops import hashing as jhash
from arrow_tpu.ops import selection as jsel
from arrow_tpu_torch import array_from_numpy, decimal128, fixed_size_binary
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.compute.scalar import Scalar as TScalar
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    array_to_pyarrow, batch_from_pyarrow
from arrow_tpu_torch.ops import hashing as thash
from arrow_tpu_torch.ops import selection as tsel

from test_torch_acero import _rows

D = decimal.Decimal
TYPES = [pa.decimal128(10, 2), pa.decimal128(38, 2), pa.decimal256(40, 3),
         pa.decimal128(18, 0)]


def _decimals(rng, n, t, nulls=0.15, lo=-30, hi=30):
    """Decimal values of ``t`` with ties; magnitudes past int64 for a
    precision past 18."""
    big = 10 ** 20 if t.precision > 18 else 1
    vals = [D(int(x) * big).scaleb(-t.scale) for x in rng.integers(lo, hi, n)]
    return pa.array(vals, t, mask=rng.random(n) < nulls)


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_decimal_stages_both_ways_as_the_jax_package(t):
    rng = np.random.default_rng(t.precision)
    a = _decimals(rng, 300, t)
    tp, jx = array_from_pyarrow(a, device="cpu"), at.array(a)
    assert tp.values.shape == tuple(jx.values.shape)
    ok = np.asarray(a.is_valid())
    np.testing.assert_array_equal(tp.values.numpy()[:300][ok],
                                  np.asarray(jx.values)[:300][ok])
    assert array_to_pyarrow(tp).equals(a)
    # array_from_numpy takes the storage as is
    made = array_from_numpy(tp.values.numpy()[:300], type=tp.type,
                            validity=ok, device="cpu")
    assert array_to_pyarrow(made).equals(a)


def test_fixed_size_binary_and_intervals_stage_both_ways():
    rng = np.random.default_rng(3)
    fsb = pa.array([bytes(rng.integers(0, 256, 3).astype(np.uint8))
                    for _ in range(50)], pa.binary(3),
                   mask=rng.random(50) < 0.2)
    mdn = pa.array([pa.MonthDayNano([int(x), int(x) % 7, int(x) * 1000])
                    for x in rng.integers(-9, 9, 40)],
                   pa.month_day_nano_interval(), mask=rng.random(40) < 0.2)
    for a in (fsb, mdn):
        tp, jx = array_from_pyarrow(a, device="cpu"), at.array(a)
        assert array_to_pyarrow(tp).equals(a)
        assert array_to_pyarrow(tp).equals(jx.to_pyarrow())
    tp = array_from_pyarrow(fsb, device="cpu")
    assert tp.values.shape == (64, 3) and tp.values.dtype == torch.uint8
    made = array_from_numpy(tp.values.numpy()[:50], type=fixed_size_binary(3),
                            validity=np.asarray(fsb.is_valid()), device="cpu")
    assert array_to_pyarrow(made).equals(fsb)
    with pytest.raises(ValueError, match="shape"):
        array_from_numpy(np.zeros(4, np.int64), type=decimal128(38, 2),
                         device="cpu")


CMPS = ["equal", "not_equal", "less", "less_equal", "greater",
        "greater_equal"]


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_decimal_comparisons_vs_jax_and_pyarrow(t):
    rng = np.random.default_rng(11 + t.precision)
    a, b = _decimals(rng, 200, t), _decimals(rng, 200, t)
    ta, tb = (array_from_pyarrow(x, device="cpu") for x in (a, b))
    ja, jb = at.array(a), at.array(b)
    pivot = a[3].as_py() if a[3].is_valid else a[4].as_py()
    for fn in CMPS:
        got = array_to_pyarrow(tcall(fn, [ta, tb]))
        assert got.equals(jcall(fn, [ja, jb]).to_pyarrow()), fn
        assert got.equals(pc.call_function(fn, [a, b])), fn
        got = array_to_pyarrow(tcall(fn, [ta, TScalar(pivot, ta.type)]))
        assert got.equals(pc.call_function(fn, [a, pa.scalar(pivot, t)]))
    # on record: the JAX package reads a decimal scalar unscaled (a wide
    # one raises)
    one = pa.array([D("12.34")], pa.decimal128(10, 2))
    assert jcall("equal", [at.array(one), JScalar(D("12.34"), at.array(
        one).type)]).to_pyarrow().to_pylist() == [False]
    assert tcall("equal", [array_from_pyarrow(one, device="cpu"), TScalar(
        D("12.34"), decimal128(10, 2))]).to_pylist() == [True]


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_decimal_group_by_sort_unique_vs_jax(t):
    rng = np.random.default_rng(17 + t.precision)
    n = 400
    k = _decimals(rng, n, t, lo=-8, hi=8)
    tbl = pa.table({"k": k, "d": _decimals(rng, n, t),
                    "v": rng.integers(-50, 50, n)})
    aggs = [("d", "sum"), ("v", "sum"), ("v", "count"), ("d", "count")]
    got = Table.from_pyarrow(tbl, max_rows_per_batch=128, device="cpu") \
        .group_by("k").aggregate(aggs).to_pyarrow()
    want = at.Table.from_pyarrow(tbl, max_rows_per_batch=128) \
        .group_by("k").aggregate(aggs).to_pyarrow()
    assert got.equals(want)
    assert got.sort_by("k").equals(tbl.group_by("k").aggregate(aggs).select(
        got.column_names).sort_by("k"))
    for order in ("ascending", "descending"):
        keys = [("k", order), ("v", "ascending")]
        got = Table.from_pyarrow(tbl, device="cpu").sort_by(keys) \
            .to_pyarrow()
        assert got.equals(at.Table.from_pyarrow(tbl).sort_by(keys)
                          .to_pyarrow())
        assert got.equals(tbl.sort_by(keys))
    tk, jk = array_from_pyarrow(k, device="cpu"), at.array(k)
    got = array_to_pyarrow(tcall("unique", [tk]))
    assert got.equals(jcall("unique", [jk]).to_pyarrow())
    assert got.equals(pc.unique(k))


@pytest.mark.parametrize("t", TYPES, ids=str)
def test_decimal_hash_vs_jax(t):
    rng = np.random.default_rng(23 + t.precision)
    a = _decimals(rng, 256, t)
    b = pa.array(rng.integers(0, 9, 256))
    for fn in ("hash32", "hash64"):
        got = getattr(thash, fn)([array_from_pyarrow(a, device="cpu"),
                                  array_from_pyarrow(b, device="cpu")])
        want = getattr(jhash, fn)([at.array(a), at.array(b)])
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "left semi", "right anti"])
@pytest.mark.parametrize("t", [pa.decimal128(12, 2), pa.decimal128(38, 2)],
                         ids=str)
def test_decimal_join_vs_jax(t, join_type):
    rng = np.random.default_rng(29 + t.precision)
    left = pa.table({"k": _decimals(rng, 150, t, lo=-10, hi=10),
                     "lv": rng.integers(0, 100, 150),
                     "ld": _decimals(rng, 150, t)})
    right = pa.table({"k": _decimals(rng, 40, t, lo=-10, hi=10),
                      "rv": rng.integers(0, 100, 40),
                      "rd": _decimals(rng, 40, t)})
    port_left = Table.from_pyarrow(left, max_rows_per_batch=64, device="cpu")
    port_right = Table.from_pyarrow(right, max_rows_per_batch=64,
                                    device="cpu")
    # the JAX package's join keeps both key columns (ROADMAP C34)
    got = port_left.join(port_right, "k", join_type=join_type,
                         coalesce_keys=False).to_pyarrow()
    # the port's default coalesces them, as pyarrow's
    assert _rows(port_left.join(port_right, "k", join_type=join_type,
                                max_build_rows=64).to_pyarrow()) == \
        _rows(left.join(right, "k", join_type=join_type))
    jtable = at.Table.from_pyarrow(left, max_rows_per_batch=64).join(
        at.Table.from_pyarrow(right, max_rows_per_batch=64), "k",
        join_type=join_type)
    if join_type == "full outer" and t.precision > 18:
        # on record: the JAX package's null probe-side columns of the
        # unmatched build rows are one int64 a row, not two limbs, and its
        # export fails; the port's answer is pyarrow's
        with pytest.raises(IndexError):
            jtable.to_pyarrow()
        # the payload columns, row for row
        want = left.join(right, "k", join_type=join_type)
        cols = ["lv", "ld", "rv", "rd"]
        assert _rows(got.select(cols)) == _rows(want.select(cols))
        return
    want = jtable.to_pyarrow()
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)


def test_filter_and_take_of_wide_columns_vs_jax():
    """A batch of a narrow and a wide decimal, a fixed-size binary, an
    interval and an int64 column: the filter (the port compacts the flat
    columns, the (cap, w) ones as byte matrices, in its one launch) and a
    take, each equal to the JAX package's."""
    rng = np.random.default_rng(31)
    n = 300
    rb = pa.record_batch({
        "n": _decimals(rng, n, pa.decimal128(9, 2)),
        "w": _decimals(rng, n, pa.decimal128(38, 4)),
        "f": pa.array([bytes(rng.integers(0, 256, 5).astype(np.uint8))
                       for _ in range(n)], pa.binary(5),
                      mask=rng.random(n) < 0.1),
        "i": pa.array([pa.MonthDayNano([int(x), 1, int(x) * 7])
                       for x in rng.integers(0, 50, n)],
                      pa.month_day_nano_interval()),
        "x": pa.array(rng.integers(0, 1000, n))})
    mask = pa.array(rng.random(n) < 0.4, mask=rng.random(n) < 0.1)
    tb, jb = batch_from_pyarrow(rb, device="cpu"), at.Batch.from_pyarrow(rb)
    got = tsel.filter_batch(tb, array_from_pyarrow(mask, device="cpu"))
    want = jsel.filter_batch(jb, at.array(mask))
    assert got.to_pyarrow().equals(want.to_pyarrow())
    assert got.to_pyarrow().equals(rb.filter(mask))
    idx = pa.array(rng.integers(0, n, 500), mask=rng.random(500) < 0.1)
    got = tsel.take_batch(tb, array_from_pyarrow(idx, device="cpu"))
    want = jsel.take_batch(jb, at.array(idx))
    assert got.to_pyarrow().equals(want.to_pyarrow())
    assert got.to_pyarrow().equals(rb.take(idx))


def test_fixed_size_binary_keys_raise_in_both_packages():
    fsb = pa.array([b"ab", b"cd", b"ab"], pa.binary(2))
    tbl = pa.table({"k": fsb, "v": [1, 2, 3]})
    with pytest.raises(NotImplementedError, match="fixed_size_binary"):
        Table.from_pyarrow(tbl, device="cpu").group_by("k").aggregate(
            [("v", "sum")])
    with pytest.raises(NotImplementedError, match="fixed_size_binary"):
        at.Table.from_pyarrow(tbl).group_by("k").aggregate([("v", "sum")])
