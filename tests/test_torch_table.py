"""Port parity: ``arrow_tpu_torch`` ``Table`` (``core/batch.py``,
``core/interop.py``) against the JAX package's ``Table``: staging a pyarrow
table in batches, the structural methods (select, drop_columns,
rename_columns, column, [], slice, take, append_column, set_column,
drop_null, combine_chunks), ``table(...)``, ``Batch.with_index`` (ROADMAP
C16), the vector functions ``drop_null`` and ``inverse_permutation``, and
the query methods that run through the plan engine (group_by with
TableGroupBy, sort_by, filter, join). Integers, nulls and row order exact;
float sums within 1e-12 * sum|x| + 1e-12 per group; joins as multisets."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jc
import arrow_tpu_torch as att
import arrow_tpu_torch.compute as tc
from test_torch_acero import _assert_equal, _rows


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 12, n)),
        "v": pa.array(rng.integers(-50, 50, n).astype(float),
                      mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(0, 9, n).astype(np.int32),
                      mask=rng.random(n) < 0.2),
    })


def _both(t, rows=32):
    return (att.Table.from_pyarrow(t, max_rows_per_batch=rows,
                                   device="cpu"),
            at.Table.from_pyarrow(t, max_rows_per_batch=rows))


def test_from_pyarrow_stages_like_jax():
    t = _data()
    tt, jt = _both(t)
    assert [len(b) for b in tt.batches] == [len(b) for b in jt.batches]
    assert [b.capacity for b in tt.batches] == \
        [b.capacity for b in jt.batches]
    assert tt.schema.to_pyarrow() == jt.schema.to_pyarrow()
    _assert_equal(tt.to_pyarrow(), jt.to_pyarrow())
    assert tt.to_pyarrow().equals(t)
    empty = att.Table.from_pyarrow(t.slice(0, 0), device="cpu")
    assert empty.num_rows == 0 and len(empty.batches) == len(
        at.Table.from_pyarrow(t.slice(0, 0)).batches)


@pytest.mark.parametrize("method", [
    ("select", (["w", "k"],)), ("drop_columns", ("v",)),
    ("rename_columns", (["a", "b", "c"],)), ("slice", (40, 50)),
    ("slice", (140,)), ("take", (np.array([5, 0, 149, 77]),)),
    ("append_column", ("z", np.arange(150) * 2)),
    ("set_column", (1, "v2", np.arange(150, dtype=np.float32))),
    ("drop_null", ()), ("combine_chunks", ())])
def test_structural_methods_vs_jax(method):
    name, args = method
    tt, jt = _both(_data())
    got = getattr(tt, name)(*args)
    want = getattr(jt, name)(*args)
    _assert_equal(got.to_pyarrow(), want.to_pyarrow())
    if name in ("select", "rename_columns", "drop_columns"):
        assert got.column_names == want.column_names


def test_column_access_and_table_constructor():
    t = _data()
    tt, jt = _both(t)
    assert tt.column("v").equals(jt.column("v"))
    assert tt["k"].equals(t["k"])
    assert tt[2].equals(jt[2])
    cols = {"a": np.arange(5), "b": np.linspace(0, 1, 5)}
    one = att.table(cols, device="cpu")
    assert len(one.batches) == 1 and one.to_pydict() == \
        at.table(cols).to_pydict()
    assert att.table(t, capacity=256, device="cpu").batches[0].capacity \
        == 256
    # Table.cast (the cast kernels, ROADMAP A7b) as the JAX package's
    assert tt.cast(tt.schema).to_pyarrow().equals(
        jt.cast(jt.schema).to_pyarrow())


def test_batch_with_index():
    """``Batch.with_index`` (ROADMAP C16): the same columns and length,
    another stream index, as in the JAX package."""
    b = att.batch_from_numpy({"a": np.arange(4)}, device="cpu")
    c = b.with_index(7)
    assert (c.index, b.index) == (7, -1)
    assert c.arrays is b.arrays and c.length == b.length
    jb = at.Batch.from_pyarrow(pa.record_batch([pa.array(np.arange(4))],
                                               names=["a"]))
    assert jb.with_index(7).index == c.index


def test_drop_null_and_inverse_permutation_vs_jax():
    rng = np.random.default_rng(3)
    perm = rng.permutation(40).astype(np.int32)
    idx = pa.array(np.concatenate([perm[:30], [45, -2, 3]]).astype(np.int32),
                   mask=np.arange(33) == 5)
    rb = pa.record_batch([idx], names=["i"])
    jb = at.Batch.from_pyarrow(rb)
    tb = att.Batch.from_pyarrow(rb, device="cpu")
    for name in ("inverse_permutation", "drop_null"):
        got = tc.call_function(name, [tb["i"]]).to_pyarrow()
        want = jc.call_function(name, [jb["i"]]).to_pyarrow()
        assert got.type == want.type and got.equals(want), name
    t = _data()
    rb = t.to_batches()[0]
    got = tc.call_function("drop_null", [att.Batch.from_pyarrow(
        rb, device="cpu")]).to_pyarrow()
    want = jc.call_function("drop_null", [at.Batch.from_pyarrow(rb)]) \
        .to_pyarrow()
    assert got.equals(want)


def test_group_by_sort_by_filter_vs_jax():
    from arrow_tpu.compute.expressions import field as jf
    from arrow_tpu_torch.compute.expressions import field as tf
    t = _data(300, 4)
    tt, jt = _both(t)
    aggs = [("v", "sum"), ("w", "min"), ([], "count_all")]
    got = tt.group_by("k").aggregate(aggs).to_pyarrow()
    want = jt.group_by("k").aggregate(aggs).to_pyarrow()
    _assert_equal(got, want)   # sums of integer-valued floats: exact
    _assert_equal(tt.group_by(["k"], [("w", "max")]).to_pyarrow(),
                  jt.group_by(["k"], [("w", "max")]).to_pyarrow())
    _assert_equal(tt.sort_by([("w", "descending"), ("v", "ascending")])
                  .to_pyarrow(),
                  jt.sort_by([("w", "descending"), ("v", "ascending")])
                  .to_pyarrow())
    _assert_equal(tt.sort_by("k").to_pyarrow(), jt.sort_by("k").to_pyarrow())
    _assert_equal(tt.filter(tf("w") > 4).to_pyarrow(),
                  jt.filter(jf("w") > 4).to_pyarrow())


def test_table_join_vs_jax():
    t = _data(200, 5)
    r = pa.table({"k": pa.array(np.arange(0, 12, 2)),
                  "r": pa.array(np.arange(6) * 1.5)})
    tt, jt = _both(t)
    tr, jr = _both(r)
    for jtype in ("inner", "left outer"):
        # the JAX package's join keeps both key columns (ROADMAP C34):
        # pyarrow's coalesce_keys=False
        got = tt.join(tr, "k", join_type=jtype, right_suffix="_r",
                      max_build_rows=64, coalesce_keys=False).to_pyarrow()
        want = jt.join(jr, "k", join_type=jtype, right_suffix="_r",
                       max_build_rows=64).to_pyarrow()
        assert got.column_names == want.column_names
        assert _rows(got) == _rows(want)
        # the default coalesces them, as pyarrow's
        got = tt.join(tr, "k", join_type=jtype, right_suffix="_r",
                      max_build_rows=64).to_pyarrow()
        want = t.join(r, "k", join_type=jtype, right_suffix="_r")
        assert got.column_names == want.column_names
        assert _rows(got) == _rows(want)
