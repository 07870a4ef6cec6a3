"""Port parity for the whole slices.

``arrow_tpu_torch.entry.entry``'s step against the chain the JAX
AggregateNode runs on the same numpy data — execute_scalar_expression ->
filter_batch -> probe_scalars -> probe_route (dense, impl "pallas") ->
consume_dense -> finalize. Same groups in the same first-appearance order;
keys, counts, int64 sums and mins and f32 mins exact; f32 sums within
|diff| <= 1e-5 * sum(|v|) + 1e-6 per group.

``entry_generic``'s step against the JAX package's own flagship step
(``__graft_entry__.entry()``: float64 ``v``, the generic consume), jitted,
on the same data: keys, their order, ``w_min`` and ``count_all`` exact; f64
sums within |diff| <= 1e-12 * sum(|v|) + 1e-12 per group (the two packages
add in another order).

``entry_sort``'s step against the JAX package's ``sort_indices_batch`` +
``take_batch`` on the same columns: the permutation and the sorted columns
equal exactly. ``entry_join``'s step (``join_routed`` picks the route)
against the JAX ``HashJoin`` driven with the same route: the same rows as
a multiset, floats by their bits.
"""

import jax
import numpy as np
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute.expressions import execute_scalar_expression, field
from arrow_tpu.ops.hash_aggregate import AggregateSpec, HashAggregate
from arrow_tpu.ops.selection import filter_batch
import __graft_entry__ as graft
from arrow_tpu_torch.entry import AGGREGATES, MAX_GROUPS, SORT_KEYS, entry, \
    entry_generic, entry_join, entry_sort, example_columns, \
    example_columns_generic, example_columns_join, example_columns_sort

N_ROWS = 4096
NUM_KEYS = 100


def _jax_chain(cols):
    b = at.batch(cols)
    ha = HashAggregate(b.schema, ["k"],
                       [AggregateSpec(s.function, s.target, s.options, s.name)
                        for s in AGGREGATES], max_groups=MAX_GROUPS)
    mask = execute_scalar_expression(field("w") > 0, b)
    filtered = filter_batch(b, mask)
    vals = jax.device_get(jax.jit(ha.probe_scalars)(filtered))
    kind, cfg = ha.probe_route(filtered, vals)
    assert (kind, cfg["impl"]) == ("dense", "pallas")
    consume = jax.jit(ha.consume_dense, static_argnums=(3, 4))
    st = consume(ha.init_state(), filtered, np.int64(cfg["lo"]), cfg["G"],
                 cfg["impl"])
    return ha.finalize(st)


@pytest.mark.parametrize("seed", [0, 1])
def test_entry_step_matches_jax_chain(seed):
    cols = example_columns(N_ROWS, NUM_KEYS, seed)
    want = _jax_chain(cols)
    step, args = entry("cpu", N_ROWS, NUM_KEYS, seed)
    got = step(*args)
    n = int(want.length)
    assert int(got.length) == n
    assert got.column_names == want.column_names
    g = {c: got.column(c).values[:n].numpy() for c in got.column_names}
    w = {c: np.asarray(want.column(c).values)[:n] for c in want.column_names}
    for c in ("k", "count_all", "w_sum", "w_min", "v_min"):
        np.testing.assert_array_equal(g[c], w[c], err_msg=c)
    for c in got.column_names:
        for a in (got.column(c), want.column(c)):
            assert a.validity is None or np.asarray(a.validity)[:n].all()
    sel = cols["w"] > 0
    abs_sum = np.bincount(cols["k"][sel], weights=np.abs(cols["v"][sel]),
                          minlength=NUM_KEYS)[g["k"]]
    d = np.abs(g["v_sum"].astype(np.float64) - w["v_sum"])
    assert (d <= 1e-5 * abs_sum + 1e-6).all(), d.max()
    # first-appearance order of the keys among the selected rows
    keys, first = np.unique(cols["k"][sel], return_index=True)
    np.testing.assert_array_equal(g["k"], keys[np.argsort(first)])


def test_entry_generic_step_matches_jax_entry():
    """At ``__graft_entry__``'s own size: 1024 rows, 16 keys, seed 0, 64
    groups."""
    fn, (jb,) = graft.entry()
    want = jax.jit(fn)(jb)
    cols = example_columns_generic(1024, 16, 0)
    for c in cols:                       # the same input in both packages
        np.testing.assert_array_equal(cols[c], np.asarray(jb[c].values))
    step, (tb,) = entry_generic("cpu", 1024, 16, 0, max_groups=64)
    assert tb["v"].values.dtype == torch.float64
    got = step(tb)
    n = int(want[-1])
    assert int(got.length) == n == 16
    assert got.column_names == ("k", "v_sum", "w_min", "count_all")
    g = [got.column(c).values[:n].numpy() for c in got.column_names]
    w = [np.asarray(x)[:n] for x in want[:-1]]
    for i in (0, 2, 3):
        np.testing.assert_array_equal(g[i], w[i], got.column_names[i])
    sel = cols["w"] > 0
    abs_sum = np.bincount(cols["k"][sel], weights=np.abs(cols["v"][sel]),
                          minlength=16)[g[0]]
    d = np.abs(g[1] - w[1])
    assert (d <= 1e-12 * abs_sum + 1e-12).all(), d.max()


@pytest.mark.parametrize("n_rows,num_keys,max_groups",
                         [(5000, 700, 1024), (3000, 3000, 2048)])
def test_entry_generic_step_matches_numpy(n_rows, num_keys, max_groups):
    cols = example_columns_generic(n_rows, num_keys, 5)
    step, args = entry_generic("cpu", n_rows, num_keys, 5, max_groups)
    got = step(*args)
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    keys, first = np.unique(k, return_index=True)
    keys = keys[np.argsort(first)]
    n = len(keys)
    assert int(got.length) == n
    np.testing.assert_array_equal(got["k"].values[:n].numpy(), keys)
    np.testing.assert_array_equal(got["count_all"].values[:n].numpy(),
                                  np.bincount(k, minlength=num_keys)[keys])
    w_min = np.full(num_keys, np.iinfo(np.int64).max)
    np.minimum.at(w_min, k, w)
    np.testing.assert_array_equal(got["w_min"].values[:n].numpy(),
                                  w_min[keys])
    v_sum = np.bincount(k, weights=v, minlength=num_keys)[keys]
    v_abs = np.bincount(k, weights=np.abs(v), minlength=num_keys)[keys]
    d = np.abs(got["v_sum"].values[:n].numpy() - v_sum)
    assert (d <= 1e-12 * v_abs + 1e-12).all(), d.max()


@pytest.mark.parametrize("n_rows,num_keys", [(3000, 40), (1024, 1000)])
def test_entry_sort_step_matches_jax(n_rows, num_keys):
    import pyarrow as pa
    from arrow_tpu.ops.selection import take_batch
    from arrow_tpu.ops.sorting import SortOptions, sort_indices_batch
    cols = example_columns_sort(n_rows, num_keys, 3)
    jb = at.Batch.from_pyarrow(pa.record_batch({
        "k1": pa.array(cols["k1"]),
        "k2": pa.array(cols["k2"], mask=~cols["k2_valid"]),
        "v": pa.array(cols["v"])}))
    jidx = sort_indices_batch(jb, SortOptions(SORT_KEYS, "at_end"))
    want = take_batch(jb, jidx)
    step, (tb,) = entry_sort("cpu", n_rows, 3, num_keys)
    assert tb.column("k2").validity is not None and \
        tb.column("k1").validity is None
    idx, got = step(tb)
    np.testing.assert_array_equal(
        idx.values.view(torch.int64).numpy()[:n_rows],
        np.asarray(jidx.values)[:n_rows].astype(np.int64))
    valid = np.asarray(want.column("k2").validity)[:n_rows]
    np.testing.assert_array_equal(
        got.column("k2").validity.numpy()[:n_rows], valid)
    for c in ("k1", "k2", "v"):
        g = got.column(c).values.numpy()[:n_rows]
        w = np.asarray(want.column(c).values)[:n_rows]
        sel = valid if c == "k2" else slice(None)
        np.testing.assert_array_equal(g[sel], w[sel], err_msg=c)
    # the independent statement of the order: k1 up, k2 down, nulls last,
    # ties in input order
    order = np.lexsort((np.arange(n_rows),
                        -cols["k2"].astype(np.int64) * cols["k2_valid"],
                        ~cols["k2_valid"], cols["k1"]))
    np.testing.assert_array_equal(
        idx.values.view(torch.int64).numpy()[:n_rows], order)


def _np_buf(x, n):
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))[:n]


def _row_multiset(b):
    """Sorted rows of either package's Batch: integers by value, floats by
    their bits, nulls as None."""
    n = int(b.length)
    cols = []
    for c in b.column_names:
        a = b.column(c)
        v = _np_buf(a.values, n)
        if v.dtype.kind == "f":
            v = v.view(np.int32 if v.dtype == np.float32 else np.int64)
        ok = np.ones(n, bool) if a.validity is None else \
            _np_buf(a.validity, n)
        cols.append([int(x) if o else None for x, o in zip(v, ok)])
    return sorted(zip(*cols), key=repr)


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "left anti"])
@pytest.mark.parametrize("shape", ["unique_uniform", "unique_zipf",
                                   "duplicates", "wide"])
def test_entry_join_step_matches_jax(join_type, shape):
    from arrow_tpu.acero.options import HashJoinNodeOptions
    from arrow_tpu.ops.join import HashJoin
    kw = {"unique_uniform": {}, "unique_zipf": {"key_dist": "zipf"},
          "duplicates": {"build_keys": 64, "fanout_capacity": 1 << 13},
          "wide": {"wide": True}}[shape]
    step, (tbb, tpb) = entry_join("cpu", 256, 1024, 7, join_type, **kw)
    hj = step.join
    from arrow_tpu_torch.entry import join_routed
    _, impl = join_routed(hj, tbb)
    want_impl = {"unique_uniform": "packed_u", "unique_zipf": "packed_u",
                 "duplicates": "packed", "wide": "sort"}[shape]
    if want_impl == "packed_u" and not hj.supports_unique_fast():
        want_impl = "packed"
    assert impl == want_impl
    out, tail = step(tbb, tpb)

    got = _row_multiset(out)
    if tail is not None:
        got = sorted(got + _row_multiset(tail), key=repr)
    # the JAX package, the same route
    bcols, pcols = example_columns_join(256, 1024, 7, kw.get("key_dist",
                                                             "uniform"),
                                        kw.get("build_keys"),
                                        kw.get("wide", False))
    jbb, jpb = at.batch(bcols), at.batch(pcols)
    keys = ["k", "k2"] if shape == "wide" else ["k"]
    jhj = HashJoin(jpb.schema, jbb.schema, HashJoinNodeOptions(
        join_type, left_keys=keys, right_keys=keys,
        left_output=keys + ["lv"], right_output=["rv"], max_build_rows=256,
        fanout_capacity=kw.get("fanout_capacity")))
    jout, jbs = jhj.probe(jhj.build(jbb), jpb, impl=impl)
    assert int(jbs.error) == 0
    want = _row_multiset(jout)
    jtail = jhj.finish(jbs)
    if jtail is not None:
        want = sorted(want + _row_multiset(jtail), key=repr)
    assert got == want
    if join_type == "inner":
        per_key = np.bincount(bcols["k"], minlength=4 * 256)
        assert len(got) == int(per_key[pcols["k"]].sum())
