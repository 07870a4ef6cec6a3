"""Port parity: the ``sorted_merge`` node (``acero/nodes.py``
``SortedMergeNode``, ``streaming_sorted_merge``) against the JAX package's
and pyarrow's sort of the concatenated inputs.

Inputs are each sorted by the keys and staged in small batches, so that a
merge streams many rounds and its inputs run out at different rounds. The
port's output equals the JAX package's row for row (the same rounds, the
same stable sorts) wherever their orders agree; against pyarrow the keys
end in a unique row id, so that the order is one. NaN under a descending
key is where the packages differ (ROADMAP C32 (a)): the port follows
pyarrow, NaN after every number; the JAX package puts it first, kept on
record here. Exact comparison throughout (no arithmetic)."""

import os

import numpy as np
import pyarrow as pa
import pytest

from test_torch_acero import JAX, PORT, _assert_equal, \
    _drop_jax_executables  # noqa: F401 (an autouse fixture)

ROWS = 16


def _inputs(seed, sizes, string_len=3):
    """One pyarrow table an input, each sorted by (a, s desc, d, id): a
    int64 with ties and nulls, s a string (``string_len`` bytes and past),
    d a dictionary of strings, x float64 a payload, id unique."""
    rng = np.random.default_rng(seed)
    out, base = [], 0
    for n in sizes:
        a = rng.integers(0, 12, n)
        words = np.array(["w%0*d" % (string_len, i) for i in range(6)])
        t = pa.table({
            "a": pa.array(a, mask=rng.random(n) < 0.1),
            "s": pa.array(rng.choice(words, n)),
            # one dictionary for every input: neither package unifies
            # the dictionaries of its sources (ROADMAP C24)
            "d": pa.DictionaryArray.from_arrays(
                pa.array(rng.integers(0, 3, n).astype(np.int32)),
                pa.array(["red", "green", "blue"])),
            "x": pa.array(rng.standard_normal(n)),
            "id": pa.array(np.arange(base, base + n))})
        base += n
        out.append(_sort(t, KEYS))
    return out


def _sort(t: pa.Table, keys, placement="at_end") -> pa.Table:
    """pyarrow's stable sort of ``t`` (dictionary keys by their values)."""
    import pyarrow.compute as pc
    return t.take(pc.sort_indices(_decoded(t), sort_keys=[
        (n, o, placement) for n, o in keys]))


KEYS = [("a", "ascending"), ("s", "descending"), ("d", "ascending"),
        ("id", "ascending")]


def _merge(P, tables, keys=KEYS, rows=ROWS, placement="at_end"):
    srcs = [P.acero.Declaration("table_source",
                                P.acero.TableSourceNodeOptions(
                                    P.table(t, rows))) for t in tables]
    return P.acero.Declaration(
        "sorted_merge", P.acero.SortedMergeNodeOptions(keys, placement),
        srcs).to_table().to_pyarrow()


def _pyarrow_merge(tables, keys=KEYS, placement="at_end"):
    return _sort(pa.concat_tables(tables).combine_chunks(), keys,
                 placement)


def _decoded(t: pa.Table) -> pa.Table:
    """Dictionary columns decoded (each package keeps its own dictionary
    object; the values are what is compared)."""
    return pa.table({n: c.combine_chunks().dictionary_decode()
                     if pa.types.is_dictionary(c.type) else c
                     for n, c in zip(t.column_names, t.columns)})


@pytest.mark.parametrize("sizes", [(70,), (5, 300), (37, 1, 200, 64, 9)],
                         ids=["one_input", "two_uneven", "five_uneven"])
def test_sorted_merge_vs_jax_and_pyarrow(sizes):
    tables = _inputs(len(sizes), sizes)
    got = _merge(PORT, tables)
    _assert_equal(_decoded(got), _decoded(_merge(JAX, tables)))
    _assert_equal(_decoded(got), _decoded(_pyarrow_merge(tables)))


def test_sorted_merge_long_strings_take_the_exact_sort():
    """Strings past the 32-byte prefix make the rest of the merge one
    exact sort with a prefix that covers them; the rows still come out
    in pyarrow's order (the keys differ only past byte 32)."""
    tables = _inputs(3, (40, 90, 25), string_len=40)
    got = _merge(PORT, tables)
    _assert_equal(_decoded(got), _decoded(_pyarrow_merge(tables)))
    _assert_equal(_decoded(got), _decoded(_merge(JAX, tables)))


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
def test_sorted_merge_nan_under_a_descending_key(placement):
    """NaN sorts after every number under a descending key, between the
    numbers and the nulls, as in pyarrow. The JAX package's merge puts it
    before the numbers (its descending lanes flip a NaN's bits too): the
    probe [3.0, 1.0, nan] and [2.0, nan] gives its rows
    [2, 4, 0, 3, 1], pyarrow's [0, 3, 1, 2, 4]."""
    a = pa.table({"v": [3.0, 1.0, float("nan")], "id": [0, 1, 2]})
    b = pa.table({"v": [2.0, float("nan")], "id": [3, 4]})
    probe = [("v", "descending")]
    assert _merge(PORT, [a, b], probe)["id"].to_pylist() == [0, 3, 1, 2, 4]
    assert _merge(JAX, [a, b], probe)["id"].to_pylist() == [2, 4, 0, 3, 1]
    keys = probe + [("id", "ascending")]
    rng = np.random.default_rng(7)
    tables = []
    for i, n in enumerate((50, 13, 80)):
        v = np.round(rng.standard_normal(n), 1)
        v[rng.random(n) < 0.15] = np.nan
        t = pa.table({"v": pa.array(v, mask=rng.random(n) < 0.1),
                      "id": np.arange(n) + 1000 * i})
        tables.append(_sort(t, keys, placement))
    got = _merge(PORT, tables, keys, rows=8, placement=placement)
    want = _pyarrow_merge(tables, keys, placement)
    assert got["id"].to_pylist() == want["id"].to_pylist()
    assert got["v"].is_null().to_pylist() == want["v"].is_null().to_pylist()
    np.testing.assert_array_equal(    # NaN equal to NaN
        got["v"].to_numpy(), want["v"].to_numpy())


def test_sorted_merge_pruned_plan_keeps_its_sort_keys():
    """A projection above the merge that drops a sort key: the projection
    pushdown must still stage the keys the merge orders by (the merge's
    branch of ``prune_columns``, as the JAX package prunes it)."""
    tables = _inputs(5, (60, 45))

    def plan(P):
        srcs = [P.acero.Declaration("table_source",
                                    P.acero.TableSourceNodeOptions(
                                        P.table(t, ROWS))) for t in tables]
        return P.acero.Declaration.from_sequence([
            P.acero.Declaration("sorted_merge",
                                P.acero.SortedMergeNodeOptions(KEYS), srcs),
            P.acero.Declaration("project", P.acero.ProjectNodeOptions(
                [P.field("x"), P.field("id")], ["x", "id"]))])
    from arrow_tpu_torch.acero.plan import prune_columns
    pruned = prune_columns(plan(PORT))
    merge = pruned.inputs[0]
    for src in merge.inputs:
        names = src.options.table.column_names
        assert set(names) == {"a", "s", "d", "id", "x"}, names
    got = plan(PORT).to_table().to_pyarrow()
    _assert_equal(got, plan(JAX).to_table().to_pyarrow())
    _assert_equal(got, _pyarrow_merge(tables).select(["x", "id"]))
    os.environ["ARROW_TPU_NO_PRUNE"] = "1"
    try:
        _assert_equal(plan(PORT).to_table().to_pyarrow(), got)
    finally:
        del os.environ["ARROW_TPU_NO_PRUNE"]


def test_streaming_sorted_merge_of_iterators():
    """The merge core over plain batch iterators (the external sort's
    finalize uses it so): inputs of 0, 1 and 4 batches, one of them only
    empty batches."""
    from arrow_tpu_torch.acero.nodes import streaming_sorted_merge
    from arrow_tpu_torch.ops.sorting import SortKey
    from arrow_tpu_torch.core.batch import Table
    tables = _inputs(9, (3, 50, 64))
    keys = [SortKey(n, o) for n, o in KEYS]
    ports = [Table.from_pyarrow(t, max_rows_per_batch=ROWS, device="cpu")
             for t in tables]
    empty = Table.from_pyarrow(tables[0].slice(0, 0), device="cpu")
    iters = [iter(p.batches) for p in ports] + [iter(empty.batches)]
    out = list(streaming_sorted_merge(iters, ports[1].schema, keys,
                                      "at_end"))
    got = pa.Table.from_batches([b.to_pyarrow() for b in out if len(b)])
    _assert_equal(_decoded(got), _decoded(_pyarrow_merge(tables)))
