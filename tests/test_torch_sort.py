"""Port parity: ``arrow_tpu_torch.ops.sorting`` against the JAX package's
``ops/sorting`` on the same numpy data. Both sorts are stable, so
permutations and ranks are equal EXACTLY, index for index; rank_quantile
and rank_normal within 1e-12.

NaN is where the port follows pyarrow and not the JAX package (ROADMAP
C32 (a)): pyarrow puts NaN between the numbers and the nulls whatever the
order, after the numbers at_end and before them at_start; the JAX package
puts it after the numbers of an ascending sort and before those of a
descending one. Where a float key holds NaN the port is held against
pyarrow (``_nan_placed`` moves the JAX package's NaN rows to pyarrow's
place, which keeps the difference on record)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import compute as jc
from arrow_tpu.ops import sorting as jsort
from arrow_tpu_torch.compute import call_function
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    batch_from_pyarrow
from arrow_tpu_torch.ops import sorting as tsort

TYPES = [pa.int64(), pa.int32(), pa.uint16(), pa.float64(), pa.float32(),
         pa.bool_(), pa.int8(), pa.uint8(), pa.int16(), pa.uint32(),
         pa.uint64(), pa.float16(), pa.date32(), pa.timestamp("us")]


def _column(rng, n, t, null_prob, small=False):
    """A pyarrow column of type ``t`` with ties, NaN, -0.0 and extremes."""
    if pa.types.is_boolean(t):
        vals = rng.random(n) < 0.5
    elif pa.types.is_floating(t):
        np_t = {16: np.float16, 32: np.float32, 64: np.float64}[t.bit_width]
        vals = (rng.standard_normal(n) * 100).astype(np_t)
        vals[rng.random(n) < 0.2] = rng.integers(-3, 3)
        vals[rng.random(n) < 0.05] = np.nan
        vals[rng.random(n) < 0.05] = -0.0
        vals[rng.random(n) < 0.05] = 0.0
        vals[rng.random(n) < 0.02] = np.inf
        vals[rng.random(n) < 0.02] = -np.inf
    else:
        np_t = np.dtype(t.to_pandas_dtype()) if not (
            pa.types.is_temporal(t)) else np.dtype(
            np.int32 if t.bit_width == 32 else np.int64)
        info = np.iinfo(np_t)
        if small:
            vals = rng.integers(0, 7, n).astype(np_t)
        else:
            vals = rng.integers(info.min, info.max, n, dtype=np_t,
                                endpoint=True)
            vals[rng.random(n) < 0.3] = rng.integers(0, 5)
            vals[rng.random(n) < 0.03] = info.min
            vals[rng.random(n) < 0.03] = info.max
    mask = rng.random(n) < null_prob if null_prob else None
    if pa.types.is_temporal(t):
        return pa.array(vals, mask=mask).cast(t)
    return pa.array(vals, type=t, mask=mask)


def _np(a):
    """values[:length] of either package's Array, as numpy."""
    v = a.values
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.uint64:
            v = v.view(torch.int64)
        return v.numpy()[:int(a.length)].astype(np.int64) \
            if not v.dtype.is_floating_point else v.numpy()[:int(a.length)]
    v = np.asarray(v)[:int(a.length)]
    return v.astype(np.int64) if v.dtype.kind in "iu" else v


def _nan_placed(perm: np.ndarray, a: pa.Array, placement: str
                ) -> np.ndarray:
    """A JAX permutation of ``a`` with its NaN rows (in the order it gives
    them) moved where pyarrow puts them: between the numbers and the nulls
    (the rows of a stable sort that tie keep their order)."""
    isnull = np.asarray(a.is_null())
    isnan = ~isnull & np.isnan(a.to_numpy(zero_copy_only=False)
                               .astype(np.float64))
    p = perm[:len(a)]
    nan, null = isnan[p], isnull[p]
    num = ~nan & ~null
    parts = (p[num], p[nan], p[null]) if placement == "at_end" else \
        (p[null], p[nan], p[num])
    return np.concatenate(parts + (perm[len(a):],))


@pytest.mark.parametrize("t", TYPES, ids=str)
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("placement", ["at_start", "at_end"])
@pytest.mark.parametrize("nulls", [0.0, 0.25])
def test_array_sort_indices_vs_jax(t, order, placement, nulls):
    rng = np.random.default_rng(len(str(t)) + (order == "ascending"))
    a = _column(rng, 777, t, nulls)
    want = jc.call_function(
        "array_sort_indices", [at.array(a)],
        options=jsort.ArraySortOptions(order, placement))
    got = call_function(
        "array_sort_indices", [array_from_pyarrow(a, device="cpu")],
        options=tsort.ArraySortOptions(order, placement))
    assert got.values.dtype == torch.uint64 and int(got.length) == 777
    want = _np(want)
    if pa.types.is_floating(t):
        moved = _nan_placed(want, a, placement)
        # on record: the JAX package places NaN otherwise in these cases
        assert np.array_equal(moved, want) == (
            (order == "ascending") == (placement == "at_end"))
        want = moved
        if t != pa.float16():       # pyarrow sorts no half floats
            np.testing.assert_array_equal(_np(got), pa.compute.sort_indices(
                a, sort_keys=[("x", order, placement)]).to_numpy())
    np.testing.assert_array_equal(_np(got), want)


def test_sort_nan_and_negative_zero():
    a = pa.array([3.0, float("nan"), 1.0, None, float("-inf"),
                  float("inf"), float("nan"), -0.0, 0.0, -0.0])
    want = jsort.sort_indices_array(at.array(a))
    got = tsort.sort_indices_array(array_from_pyarrow(a, device="cpu"))
    np.testing.assert_array_equal(_np(got), _np(want))
    # -0.0 and 0.0 tie and keep input order; NaNs after +inf, then null
    assert _np(got).tolist() == [4, 7, 8, 9, 2, 0, 5, 1, 6, 3]


def _table(rng, n):
    return pa.record_batch({
        "a": pa.array(rng.integers(0, 10, n)),
        "b": _column(rng, n, pa.float64(), 0.2),
        "c": _column(rng, n, pa.int32(), 0.1, small=True),
        "d": _column(rng, n, pa.uint64(), 0.0),
    })


@pytest.mark.parametrize("placement", ["at_start", "at_end"])
@pytest.mark.parametrize("keys", [
    [("a", "ascending"), ("b", "descending"), ("c", "ascending")],
    [("c", "descending"), ("a", "descending")],
    [("b", "ascending"), ("d", "descending"), ("a", "ascending"),
     ("c", "ascending")],
], ids=["a+b-c+", "c-a-", "b+d-a+c+"])
def test_sort_indices_batch_vs_jax(keys, placement):
    rng = np.random.default_rng(11)
    rb = _table(rng, 1500)
    want = jc.call_function(
        "sort_indices", [at.Batch.from_pyarrow(rb)],
        options=jsort.SortOptions(keys, placement))
    got = call_function(
        "sort_indices", [batch_from_pyarrow(rb, device="cpu")],
        options=tsort.SortOptions(keys, placement))
    np.testing.assert_array_equal(_np(got), pa.compute.sort_indices(
        rb, sort_keys=[(n, o, placement) for n, o in keys]).to_numpy())
    # on record: the JAX package differs where the float key b, which
    # holds NaN, sorts descending with nulls at_end or ascending with
    # nulls at_start
    jax_differs = any(n == "b" and ((o == "descending") ==
                                    (placement == "at_end"))
                      for n, o in keys)
    assert np.array_equal(_np(got), _np(want)) != jax_differs


def test_sort_is_stable_and_pads_last():
    """Equal keys keep input order; rows past the length go last, in
    order, whatever their keys."""
    rng = np.random.default_rng(3)
    rb = pa.record_batch({"k": pa.array(rng.integers(0, 4, 600))})
    jb = at.Batch.from_pyarrow(rb, capacity=1024)
    tb = batch_from_pyarrow(rb, capacity=1024, device="cpu")
    opts = [("k", "descending")]
    want = np.asarray(jsort.sort_indices_batch(
        jb, jsort.SortOptions(opts)).values).astype(np.int64)
    got = tsort.sort_indices_batch(tb, tsort.SortOptions(opts))
    g = got.values.view(torch.int64).numpy()
    np.testing.assert_array_equal(g, want)
    np.testing.assert_array_equal(g[600:], np.arange(600, 1024))
    k = rb.column(0).to_numpy()[g[:600]]
    same = k[1:] == k[:-1]
    assert (np.diff(g[:600])[same] > 0).all()


def test_batch_key_lanes_and_lex_leq_vs_jax():
    rng = np.random.default_rng(5)
    rb = _table(rng, 400)
    keys = [jsort.SortKey("b", "descending"), jsort.SortKey("c"),
            jsort.SortKey("d", "descending")]
    tkeys = [tsort.SortKey(k.name, k.order) for k in keys]
    for placement in ("at_start", "at_end"):
        want = jsort.batch_key_lanes(at.Batch.from_pyarrow(rb), keys,
                                     placement)
        tb = batch_from_pyarrow(rb, device="cpu")
        got = tsort.batch_key_lanes(tb, tkeys, placement)
        assert len(got) == len(want)
        # b's NaN rows: all ones at_end, all zero at_start (the JAX
        # package flips them with the numbers' bits)
        b = rb.column("b")
        nan = np.zeros(tb.capacity, bool)
        nan[:len(b)] = ~np.asarray(b.is_null()) & np.isnan(
            b.to_numpy(zero_copy_only=False))
        edge = 0xFFFFFFFF if placement == "at_end" else 0
        want = [np.asarray(w).astype(np.int64) for w in want]
        for i in (1, 2):            # b's value lanes follow its null lane
            want[i] = np.where(nan, edge, want[i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        same = tsort.merge_key_lanes(tb, tkeys, placement)
        assert all(torch.equal(x, y) for x, y in zip(same, got))
        bound = [int(w[17]) for w in want]
        np.testing.assert_array_equal(
            tsort.lex_leq(got, bound).numpy(),
            np.asarray(jsort.lex_leq([w.astype(np.uint32) for w in want],
                                     [np.uint32(w[17]) for w in want])))


@pytest.mark.parametrize("k", [0, 5, 100, 5000])
@pytest.mark.parametrize("nulls", [0.0, 0.4])
def test_select_k_vs_jax(k, nulls):
    rng = np.random.default_rng(k + 1)
    a = _column(rng, 300, pa.int32(), nulls, small=True)
    keys = [("x", "descending")]
    want = jc.call_function("select_k_unstable", [at.array(a)],
                            options=jsort.SelectKOptions(k, keys))
    got = call_function("select_k_unstable",
                        [array_from_pyarrow(a, device="cpu")],
                        options=tsort.SelectKOptions(k, keys))
    assert int(got.length) == int(want.length)
    np.testing.assert_array_equal(_np(got), _np(want))
    rb = _table(rng, 300)
    bkeys = [("c", "ascending"), ("b", "descending")]
    want = jc.call_function("select_k_unstable", [at.Batch.from_pyarrow(rb)],
                            options=jsort.SelectKOptions(k, bkeys))
    got = call_function("select_k_unstable",
                        [batch_from_pyarrow(rb, device="cpu")],
                        options=tsort.SelectKOptions(k, bkeys))
    # the same count; the rows pyarrow's stable sort gives first (b holds
    # NaN under a descending key, which the JAX package puts first)
    assert int(got.length) == int(want.length)
    n = int(want.length)
    np.testing.assert_array_equal(_np(got), pa.compute.sort_indices(
        rb, sort_keys=[(c, o, "at_end") for c, o in bkeys]).to_numpy()[:n])


@pytest.mark.parametrize("tiebreaker", ["min", "max", "first", "dense"])
@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("t,nulls", [(pa.int32(), 0.0), (pa.int32(), 0.3),
                                     (pa.float64(), 0.2)],
                         ids=["i32", "i32_nulls", "f64_nulls"])
def test_rank_vs_jax(tiebreaker, order, t, nulls):
    rng = np.random.default_rng(17)
    a = _column(rng, 500, t, nulls, small=True)
    for placement in ("at_start", "at_end"):
        jo = jsort.RankOptions([("x", order)], placement, tiebreaker)
        to = tsort.RankOptions([("x", order)], placement, tiebreaker)
        want = jc.call_function("rank", [at.array(a, capacity=512)],
                                options=jo)
        got = call_function(
            "rank", [array_from_pyarrow(a, capacity=512, device="cpu")],
            options=to)
        assert got.values.dtype == torch.uint64
        if pa.types.is_floating(t) or nulls:
            # NaN ranks as pyarrow ranks it, between the numbers and the
            # nulls, and the null rows tie; the JAX package ranks NaN as
            # it sorts it, and the null rows by the values under them
            pyarrow = pa.compute.rank(
                a, sort_keys=order, null_placement=placement,
                tiebreaker=tiebreaker).to_numpy().astype(np.int64)
            np.testing.assert_array_equal(_np(got), pyarrow)
            assert np.array_equal(_np(got), _np(want)) == (
                tiebreaker == "first" and not (pa.types.is_floating(t) and
                                               (order == "ascending") !=
                                               (placement == "at_end")))
        else:
            np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("fn", ["rank_quantile", "rank_normal"])
def test_rank_quantile_and_normal_vs_jax(fn):
    rng = np.random.default_rng(23)
    a = _column(rng, 400, pa.float32(), 0.1)
    want = jc.call_function(fn, [at.array(a)], options=jsort.RankOptions())
    got = call_function(fn, [array_from_pyarrow(a, device="cpu")],
                        options=tsort.RankOptions())
    assert got.values.dtype == torch.float64
    # pyarrow's: the null rows tie (the JAX package's rank them by the
    # values under them, kept on record)
    np.testing.assert_allclose(_np(got), getattr(pa.compute, fn)(a)
                               .to_numpy(), rtol=0, atol=1e-12)
    assert not np.allclose(_np(got), _np(want), rtol=0, atol=1e-12)


def test_partition_nth_vs_jax():
    rng = np.random.default_rng(29)
    a = _column(rng, 300, pa.int64(), 0.2)
    want = jc.call_function("partition_nth_indices", [at.array(a)],
                            options=jsort.PartitionNthOptions(100))
    got = call_function("partition_nth_indices",
                        [array_from_pyarrow(a, device="cpu")],
                        options=tsort.PartitionNthOptions(100))
    np.testing.assert_array_equal(_np(got), _np(want))


def test_sort_empty_input():
    a = pa.array([], type=pa.int64())
    ta = array_from_pyarrow(a, capacity=8, device="cpu")
    got = tsort.sort_indices_array(ta)
    assert int(got.length) == 0
    np.testing.assert_array_equal(got.values.view(torch.int64).numpy(),
                                  np.arange(8))
    for tb in ("min", "max", "first", "dense"):
        r = call_function("rank", [ta],
                          options=tsort.RankOptions(tiebreaker=tb))
        assert int(r.length) == 0 and r.capacity == 8


def test_sort_then_take_uint64_indices():
    """``take`` accepts the uint64 indices ``sort_indices`` returns."""
    rng = np.random.default_rng(31)
    rb = _table(rng, 200)
    tb = batch_from_pyarrow(rb, device="cpu")
    idx = tsort.sort_indices_batch(tb, tsort.SortOptions([("a", "ascending")]))
    out = call_function("take", [tb, idx])
    a = out.column("a").values.numpy()[:200]
    assert int(out.length) == 200 and (np.diff(a) >= 0).all()


def test_varlen_and_dictionary_keys_name_their_queue_item():
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.core.array import dictionary_from_numpy, \
        varlen_from_numpy
    # ported: 8 prefix words and the length, or a dictionary's rank
    s = varlen_from_numpy(np.array([b"b", b"", b"ab"]), device="cpu")
    lanes = tsort.sortable_lanes(s)
    assert len(lanes) == 9 and lanes[8].tolist() == [1, 0, 2]
    assert lanes[0].tolist() == [0x62000000, 0, 0x61620000]
    d = dictionary_from_numpy(np.array([0, 1, 2]), s, device="cpu")
    assert [x.tolist() for x in tsort.sortable_lanes(d)] == [[2, 0, 1]]
    assert Array is not None and dt.string.is_varlen
