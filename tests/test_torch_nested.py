"""Port parity of the nested layouts and ``ops/nested``: list, large list,
fixed-size list, map, struct and union columns through interop, take,
filter (the one-launch route with nested columns among flat ones) and
concat; the eight nested functions; ``hash_list`` through
``Table.group_by``, the aggregate node and ``DistContext.group_by`` over 4
logical shards; the registry. Each held against the JAX package on the same
pyarrow input (buffers compared: offsets, codes, validity and values) and
against pyarrow; where the JAX package differs from pyarrow (ROADMAP C30)
the port follows pyarrow and the difference stays on record.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
from arrow_tpu import compute as jc
from arrow_tpu.core import interop as jinterop
from arrow_tpu.ops import concat as jconcat
from arrow_tpu.ops import selection as jsel
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.ops import concat as tconcat
from arrow_tpu_torch.ops import selection as tsel
from arrow_tpu_torch.utils.errors import ArrowInvalid
from torch_parity import assert_layout_same


def _stage(arr, capacity=None):
    return (tinterop.array_from_pyarrow(arr, capacity=capacity,
                                        device="cpu"),
            jinterop.array_from_pyarrow(arr, capacity=capacity))


ST = pa.struct([("a", pa.int64()), ("b", pa.string())])
MAP = pa.map_(pa.string(), pa.int64())
UNION_CHILDREN = [pa.array([1, 2, 3, 4, 5], pa.int64()),
                  pa.array(["a", "bb", None, "d", "e"])]


def _layouts():
    return {
        "list": pa.array([[1, 2], None, [], [3, None], [4, 5, 6], [7]],
                         pa.list_(pa.int64())),
        "large_list": pa.array([[1], [2, 3], None, [], [4], [5, 6]],
                               pa.large_list(pa.int32())),
        "list_string": pa.array([["ab", None], [], None, ["xyz", ""], ["q"],
                                 ["r", "s"]], pa.list_(pa.string())),
        "list_list": pa.array([[[1], [2, 3]], None, [[]], [[4]], [], [[5]]],
                              pa.list_(pa.list_(pa.int64()))),
        "fixed_size_list": pa.array([[1, 2], [3, 4], None, [5, 6], [7, 8],
                                     [9, 0]], pa.list_(pa.int64(), 2)),
        "map": pa.array([[("a", 1), ("b", 2)], [], None, [("c", None)],
                         [("a", 7)], [("d", 4), ("a", 5)]], MAP),
        "struct": pa.array([{"a": 1, "b": "x"}, None,
                            {"a": None, "b": "yy"}, {"a": 4, "b": None},
                            {"a": 5, "b": "zz"}, {"a": 6, "b": ""}], ST),
        "sparse_union": pa.UnionArray.from_sparse(
            pa.array([0, 1, 1, 0, 1], pa.int8()), UNION_CHILDREN),
        "dense_union": pa.UnionArray.from_dense(
            pa.array([0, 1, 0, 1, 0], pa.int8()),
            pa.array([0, 0, 1, 1, 2], pa.int32()),
            [pa.array([10, None, 30], pa.int64()),
             pa.array(["p", "q"])]),
    }


LAYOUTS = _layouts()


def _plain(arr):
    return arr.cast(pa.list_(arr.type.value_type)) \
        if pa.types.is_large_list(arr.type) else arr


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_roundtrip_take_filter_match_jax_and_pyarrow(name):
    """Interop both ways; take (null and repeated indices) and filter
    (with a null in the mask, drop and emit_null) equal pyarrow's and the
    JAX package's buffers. A union has no validity of its own: its take
    and filter are held at non-null indices and a mask without nulls."""
    arr = LAYOUTS[name]
    n = len(arr)
    union = "union" in name
    t, j = _stage(arr)
    assert t.to_pyarrow().equals(_plain(arr))
    assert_layout_same(t, j)
    idx = pa.array([n - 1, 0, 1 if union else None, 2, 0], pa.int32())
    ti, ji = _stage(idx)
    got = tsel.take_array(t, ti)
    assert got.to_pyarrow().to_pylist() == arr.take(idx).to_pylist()
    fsl = name == "fixed_size_list"
    if fsl:
        # C30 (f): a null index takes k child rows in Arrow's layout and
        # the port's; the JAX package gives it none, so its offsets are no
        # longer arange * k
        np.testing.assert_array_equal(got.offsets[:6].numpy(),
                                      np.arange(6) * 2)
        np.testing.assert_array_equal(
            np.asarray(jsel.take_array(j, ji).offsets)[:6],
            [0, 2, 4, 4, 6, 8])
    elif not union:
        assert_layout_same(got, jsel.take_array(j, ji))
    mask = pa.array(([True, False, False if union else None] * 3)[:n])
    tm, jm = _stage(mask)
    for nsb in ("drop", "emit_null"):
        opts = tsel.FilterOptions(nsb)
        got = tsel.filter_array(t, tm, opts)
        assert got.to_pyarrow().to_pylist() == \
            arr.filter(mask, null_selection_behavior=nsb).to_pylist()
        if not union and not (fsl and nsb == "emit_null"):
            assert_layout_same(got, jsel.filter_array(
                j, jm, jsel.FilterOptions(nsb)))


def test_union_take_differs_only_in_padding():
    """A union's take: codes and offsets equal the JAX package's on the
    taken rows (the JAX sparse take keeps the padding codes it took)."""
    for name in ("sparse_union", "dense_union"):
        arr = LAYOUTS[name]
        t, j = _stage(arr)
        ti, ji = _stage(pa.array([4, 1, 0], pa.int32()))
        got, want = tsel.take_array(t, ti), jsel.take_array(j, ji)
        np.testing.assert_array_equal(got.values[:3].numpy(),
                                      np.asarray(want.values)[:3])
        assert got.to_pyarrow().to_pylist() == \
            want.to_pyarrow().to_pylist()


@pytest.mark.parametrize("nsb", ["drop", "emit_null"])
def test_filter_batch_with_nested_columns(nsb):
    """A batch of flat, string, list, struct and map columns through the
    default (one-launch) route: flat and varlen columns compacted by the
    compaction kernel's plain version, nested ones taken at one set of
    take indices; equal to pyarrow's filter and to the JAX package's."""
    rng = np.random.default_rng(3)
    n = 300
    lists = [None if rng.random() < 0.1 else
             [int(x) for x in rng.integers(0, 9, rng.integers(0, 4))]
             for _ in range(n)]
    rb = pa.record_batch({
        "i": pa.array(rng.integers(0, 100, n)),
        "s": pa.array([f"s{k}" * (k % 3) for k in range(n)]),
        "l": pa.array(lists, pa.list_(pa.int64())),
        "st": pa.array([{"a": int(k), "b": str(k)} if k % 7 else None
                        for k in range(n)], ST),
        "m": pa.array([[("k", int(k))] if k % 5 else [] for k in range(n)],
                      MAP)})
    mask = pa.array(rng.random(n) < 0.4, mask=rng.random(n) < 0.05)
    tb = tinterop.batch_from_pyarrow(rb, device="cpu")
    jb = at.Batch.from_pyarrow(rb)
    tm, jm = _stage(mask)
    got = tsel.filter_batch(tb, tm, tsel.FilterOptions(nsb))
    want = jsel.filter_batch(jb, jm, jsel.FilterOptions(nsb))
    exp = rb.filter(mask, null_selection_behavior=nsb)
    assert tinterop.batch_to_pyarrow(got).equals(exp)
    for i in range(rb.num_columns):
        assert_layout_same(got.column(i).with_length(int(got.length)),
                           want.column(i).with_length(int(want.length)))


@pytest.mark.parametrize("name", ["list", "list_string", "list_list",
                                  "fixed_size_list", "map", "struct"])
def test_concat_nested_matches_pyarrow(name):
    """C30 (d): the port concatenates list, fixed-size-list, map and
    struct columns (host and device lengths) as ``pa.concat_arrays``; the
    JAX ``concat_arrays`` raises on them."""
    arr = LAYOUTS[name]
    parts = [arr.slice(0, 4), arr.slice(4)]
    ts = [tinterop.array_from_pyarrow(p, device="cpu") for p in parts]
    want = pa.concat_arrays([_plain(p) for p in parts])
    assert tconcat.concat_arrays(ts).to_pyarrow().equals(want)
    dyn = [a.with_length(torch.tensor(len(a), dtype=torch.int32))
           for a in ts]
    assert tconcat.concat_arrays(dyn).to_pyarrow().equals(want)
    js = [jinterop.array_from_pyarrow(p) for p in parts]
    with pytest.raises((IndexError, ValueError, TypeError)):
        jconcat.concat_arrays(js).to_pyarrow()


@pytest.mark.parametrize("name", ["sparse_union", "dense_union"])
def test_concat_union_raises(name):
    t = tinterop.array_from_pyarrow(LAYOUTS[name], device="cpu")
    with pytest.raises(NotImplementedError, match="union"):
        tconcat.concat_arrays([t, t])


def test_order_by_over_two_batches_with_a_list_column():
    """C30 (d): an order_by plan over a two-batch table with a list column
    concatenates it (the JAX plan raises a TypeError)."""
    from arrow_tpu.acero import Declaration as JDecl
    from arrow_tpu.acero import OrderByNodeOptions as JOrder
    from arrow_tpu.acero import TableSourceNodeOptions as JSource
    from arrow_tpu_torch.acero import Declaration, OrderByNodeOptions, \
        TableSourceNodeOptions
    t = pa.table({"k": [3, 1, 2, 5, 4, 0],
                  "l": pa.array([[1], [2, 3], None, [], [4], [5, 6]])})
    tt = Table.from_pyarrow(t, max_rows_per_batch=3, device="cpu")
    got = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(tt)),
        Declaration("order_by", OrderByNodeOptions([("k", "ascending")]))
    ]).to_table().to_pyarrow()
    assert got.equals(t.sort_by("k"))
    with pytest.raises(TypeError):
        JDecl.from_sequence([
            JDecl("table_source", JSource(at.Table.from_pyarrow(
                t, max_rows_per_batch=3))),
            JDecl("order_by", JOrder([("k", "ascending")]))]).to_table()


# ---- the functions -----------------------------------------------------------

LISTS = pa.array([[1, 2, 3, 4, 5], [], None, [7], [8, 9], [None, 10]],
                 pa.list_(pa.int64()))


@pytest.mark.parametrize("fn,arr", [
    ("list_value_length", LISTS), ("list_parent_indices", LISTS),
    ("list_flatten", LISTS), ("list_flatten", LAYOUTS["list_string"]),
    ("list_flatten", LAYOUTS["list_list"]),
    ("list_flatten", LAYOUTS["fixed_size_list"])])
def test_list_functions(fn, arr):
    t, j = _stage(arr)
    got, want = tc.call_function(fn, [t]), jc.call_function(fn, [j])
    assert got.to_pyarrow().to_pylist() == \
        getattr(pc, fn)(arr).to_pylist()
    assert str(got.type) == str(want.type)
    assert_layout_same(got, want)


@pytest.mark.parametrize("start,stop,step", [
    (0, None, 1), (1, 6, 2), (0, None, 3), (2, 3, 1), (0, 7, 4),
    (3, None, 2), (1, 2, 1)])
def test_list_slice(start, stop, step):
    from arrow_tpu.ops.nested import ListSliceOptions as JOpts
    from arrow_tpu_torch.ops.nested import ListSliceOptions
    t, j = _stage(LISTS)
    got = tc.call_function("list_slice", [t],
                           ListSliceOptions(start, stop, step))
    want = jc.call_function("list_slice", [j], JOpts(start, stop, step))
    assert got.to_pylist() == \
        pc.list_slice(LISTS, start, stop, step).to_pylist()
    assert_layout_same(got, want)


def test_list_element_in_range():
    arr = pa.array([[1, 2, 3], None, [7, 8], [None, 10]],
                   pa.list_(pa.int64()))
    t, j = _stage(arr)
    for i in (0, 1):
        got = tc.call_function("list_element", [t, i])
        assert got.to_pylist() == pc.list_element(arr, i).to_pylist()
        assert_layout_same(got, jc.call_function("list_element", [j, i]))


@pytest.mark.parametrize("index", [1, -1, 5])
def test_list_element_out_of_range_raises_as_pyarrow(index):
    """C30 (c): pyarrow raises for an index outside [0, len) of a non-null
    list, and so does the port; the JAX package gives null (or counts -1
    from the end)."""
    t, j = _stage(LISTS)
    with pytest.raises(pa.ArrowInvalid):
        pc.list_element(LISTS, index)
    with pytest.raises(ArrowInvalid, match="out of bounds"):
        tc.call_function("list_element", [t, index])
    jax_got = jc.call_function("list_element", [j, index]).to_pylist()
    assert jax_got == {1: [2, None, None, None, 9, 10],
                       -1: [5, None, None, 7, 9, 10],
                       5: [None] * 6}[index]


def test_make_struct_and_struct_field():
    from arrow_tpu.ops.nested import MakeStructOptions as JMake
    from arrow_tpu.ops.nested import StructFieldOptions as JField
    from arrow_tpu_torch.ops.nested import MakeStructOptions, \
        StructFieldOptions
    a = pa.array([1, None, 3], pa.int64())
    b = pa.array(["x", "y", None])
    (ta, ja), (tb, jb) = _stage(a), _stage(b)
    got = tc.call_function("make_struct", [ta, tb],
                           MakeStructOptions(["a", "b"]))
    want = jc.call_function("make_struct", [ja, jb], JMake(["a", "b"]))
    assert got.to_pyarrow().equals(pc.make_struct(a, b,
                                                  field_names=["a", "b"]))
    assert_layout_same(got, want)
    st = LAYOUTS["struct"]
    t, j = _stage(st)
    for kw in ({"name": "b"}, {"indices": [0]}):
        g = tc.call_function("struct_field", [t], StructFieldOptions(**kw))
        w = jc.call_function("struct_field", [j], JField(**kw))
        assert g.to_pylist() == pc.struct_field(
            st, [0] if "indices" in kw else "b").to_pylist()
        assert_layout_same(g, w)


@pytest.mark.parametrize("occurrence", ["first", "last", "all"])
def test_map_lookup(occurrence):
    from arrow_tpu.ops.nested import MapLookupOptions as JOpts
    from arrow_tpu_torch.ops.nested import MapLookupOptions
    m = pa.array([[("a", 1), ("b", 2), ("a", 3)], [], None, [("c", 9)],
                  [("a", 7)], [("a", None), ("a", 4)]], MAP)
    t, j = _stage(m)
    got = tc.call_function("map_lookup", [t],
                           MapLookupOptions(pa.scalar("a"), occurrence))
    want = jc.call_function("map_lookup", [j],
                            JOpts(pa.scalar("a"), occurrence))
    assert got.to_pylist() == \
        pc.map_lookup(m, pa.scalar("a"), occurrence).to_pylist()
    assert got.to_pylist() == want.to_pylist()


# ---- hash_list -------------------------------------------------------------------

def _list_table(rng, n=600, dtype=pa.int64()):
    if pa.types.is_boolean(dtype):
        vals = rng.random(n) < 0.5
    elif pa.types.is_unsigned_integer(dtype):
        vals = rng.integers(0, 1 << 62, n).astype(np.uint64) * 3
    else:
        vals = rng.integers(-50, 50, n)
    return pa.table({"k": pa.array(rng.integers(0, 7, n)),
                     "v": pa.array(vals, dtype, mask=rng.random(n) < 0.2)})


def _as_dict(t):
    return dict(zip(t["k"].to_pylist(), t["v_list"].to_pylist()))


@pytest.mark.parametrize("dtype", [pa.int64(), pa.uint64(), pa.bool_(),
                                   pa.float32()])
def test_hash_list_matches_pyarrow_and_jax(dtype):
    """``Table.group_by`` with ``list`` over batches of 128 rows: each
    group's values in input order, as pyarrow's (use_threads=False) and
    the JAX HashAggregate's."""
    from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
    from arrow_tpu.ops.hash_aggregate import HashAggregate as JHA
    t = _list_table(np.random.default_rng(5), dtype=dtype)
    tt = Table.from_pyarrow(t, max_rows_per_batch=128, device="cpu")
    got = tt.group_by("k").aggregate([("v", "list")]).to_pyarrow()
    exp = t.group_by("k", use_threads=False).aggregate([("v", "list")])
    assert _as_dict(got) == _as_dict(exp)
    jt = at.Table.from_pyarrow(t, max_rows_per_batch=128)
    ha = JHA(jt.schema, ["k"], [JSpec("list", "v")], max_groups=16)
    st = ha.init_state()
    for b in jt.batches:
        st = ha.consume(st, b)
    assert _as_dict(got) == _as_dict(ha.finalize(st).to_pyarrow())


def test_hash_list_full_buffer_raises_naming_buffer_rows():
    """C30 (a): 100,000 int64 rows over 4 keys in 4 batches of 25,000
    against 65,536 buffer rows: the port raises through the aggregate node
    and names ``buffer_rows``; the JAX package keeps 50,000 of the values
    and reports nothing. With ``buffer_rows`` raised the lists are whole."""
    from types import SimpleNamespace

    from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
    from arrow_tpu.ops.hash_aggregate import HashAggregate as JHA
    from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec
    rng = np.random.default_rng(0)
    t = pa.table({"k": pa.array(rng.integers(0, 4, 100_000)),
                  "v": pa.array(rng.integers(0, 1000, 100_000))})
    tt = Table.from_pyarrow(t, max_rows_per_batch=25_000, device="cpu")
    with pytest.raises(RuntimeError, match="buffer_rows"):
        tt.group_by("k").aggregate([("v", "list")])
    got = tt.group_by("k").aggregate([AggregateSpec(
        "hash_list", "v", SimpleNamespace(buffer_rows=1 << 17),
        "v_list")]).to_pyarrow()
    assert sum(len(x) for x in got["v_list"].to_pylist()) == 100_000
    jt = at.Table.from_pyarrow(t, max_rows_per_batch=25_000)
    ha = JHA(jt.schema, ["k"], [JSpec("list", "v")], max_groups=8)
    st = ha.init_state()
    for b in jt.batches:
        st = ha.consume(st, b)
    assert ha.aggregator_errors(st) == []
    out = ha.finalize(st).to_pyarrow()
    assert sum(len(x) for x in out["v_list"].to_pylist()) == 50_000


def test_hash_list_over_four_shards():
    """``DistContext.group_by`` over 4 logical shards (the raw-row
    shuffle, ``list``'s state is not row-shaped) against one device; a
    buffer too small retries with ``buffer_rows`` grown."""
    from types import SimpleNamespace

    from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec
    from arrow_tpu_torch.parallel import DistContext
    t = _list_table(np.random.default_rng(9), n=2000)
    b = tinterop.batch_from_pyarrow(t, device="cpu")
    one = Table.from_pyarrow(t, device="cpu").group_by("k").aggregate(
        [("v", "list")]).to_pyarrow()
    ctx = DistContext(devices=["cpu"] * 4)
    for opts in (None, SimpleNamespace(buffer_rows=256)):
        got = ctx.group_by(b, ["k"], [AggregateSpec("hash_list", "v", opts,
                                                    "v_list")],
                           max_groups_per_shard=16).to_pyarrow()
        assert _as_dict(got) == _as_dict(one)


def test_registry_matches_the_jax_modules():
    """The port registers every function the JAX package's ``nested``,
    ``ree``, ``pivot`` and the nested part of ``strings_regex`` register
    (the 19), with the same kinds, and loads the same 17 kernel modules in
    the same order."""
    import importlib
    jreg = importlib.import_module("arrow_tpu.compute.registry")
    treg = importlib.import_module("arrow_tpu_torch.compute.registry")
    assert treg._KERNEL_MODULES == jreg._KERNEL_MODULES
    names = ["list_value_length", "list_parent_indices", "list_flatten",
             "make_struct", "struct_field", "list_element", "list_slice",
             "map_lookup", "split_pattern", "split_pattern_regex",
             "utf8_split_whitespace", "ascii_split_whitespace",
             "extract_regex", "extract_regex_span", "binary_join",
             "run_end_encode", "run_end_decode", "random", "pivot_wider"]
    assert len(set(names)) == 19
    jreg.registry.list_functions()
    jmods = {"arrow_tpu.ops.nested", "arrow_tpu.ops.ree",
             "arrow_tpu.ops.pivot"}
    assert {n for n, f in jreg.registry._functions.items()
            if f.exec.__module__ in jmods} <= set(names)
    for n in names:
        assert n in treg.registry, n
        assert treg.registry.get(n).kind.name == \
            jreg.registry.get(n).kind.name, n
    for n in ("ListSliceOptions", "MakeStructOptions", "StructFieldOptions",
              "MapLookupOptions", "SplitOptions", "SplitPatternOptions",
              "ExtractRegexOptions", "RandomOptions", "PivotWiderOptions"):
        assert getattr(tc, n).__name__ == n
