"""Port parity: the distributed group-by (``DistContext.group_by``,
``DistGroupBy``) against the JAX package on the 8-virtual-device CPU mesh;
the port runs 8 logical shards on the CPU.

The results must be equal PER SHARD AND IN ROW ORDER: the same shards hold
rows, and on each the same groups in the same order, with equal keys, nulls,
counts, integer sums (unsigned ones bit for bit) and min / max. Float sums
and means are added in another order by the two packages: f64 within
|diff| <= 1e-12 * sum(|v|) + 1e-12 per group (ROADMAP C5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu.parallel import DistGroupBy as JDistGroupBy
from arrow_tpu_torch.compute.expressions import field
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import entry_distributed, example_columns_generic
from arrow_tpu_torch.parallel import DistContext, DistGroupBy, dist_agg

N = 8


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _abs_sums(table, keys, col):
    out = {}
    ks = list(zip(*[table[k].to_pylist() for k in keys]))
    for k, v in zip(ks, table[col].to_pylist()):
        if v is not None:
            out[k] = out.get(k, 0.0) + abs(v)
    return out


def _assert_same_per_shard(got, want, source, keys, float_cols=()):
    """``got`` (port Table) and ``want`` (JAX Table): the same shards hold
    rows, and each shard's batch is equal in row order."""
    assert got.schema.to_pyarrow().equals(want.schema.to_pyarrow())
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    assert got.num_rows == want.num_rows
    for gb, wb in zip(got.batches, want.batches):
        g, w = gb.to_pyarrow(), wb.to_pyarrow()
        for name in w.schema.names:
            assert g[name].type == w[name].type, name
            assert g[name].is_null().to_pylist() == \
                w[name].is_null().to_pylist(), name
            if name in float_cols:
                base = name.rsplit("_", 1)[0]
                abs_sums = _abs_sums(source, keys, base)
                ks = list(zip(*[g[k].to_pylist() for k in keys]))
                for k, a, b in zip(ks, g[name].to_pylist(),
                                   w[name].to_pylist()):
                    if a is not None:
                        assert abs(a - b) <= 1e-12 * abs_sums[k] + 1e-12, \
                            (name, k, a, b)
            else:
                assert g[name].to_pylist() == w[name].to_pylist(), name


def _both(ctx, jctx, t, keys, aggs, **kw):
    rb = t.to_batches()[0]
    got = ctx.group_by(batch_from_pyarrow(rb, device="cpu"), keys, aggs, **kw)
    want = jctx.group_by(at.Batch.from_pyarrow(rb), keys, aggs, **kw)
    return got, want


def test_dist_group_by_vs_jax(ctx, jctx, rng):
    n = 4096
    t = pa.table({"k": pa.array(rng.integers(0, 37, n)),
                  "v": pa.array(rng.standard_normal(n))})
    got, want = _both(ctx, jctx, t, ["k"], [("sum", "v"), ("count_all",)],
                      max_groups_per_shard=64)
    _assert_same_per_shard(got, want, t, ["k"], float_cols=("v_sum",))
    exp = t.group_by("k").aggregate([("v", "sum"), ([], "count_all")]) \
        .sort_by([("k", "ascending")])
    g = got.to_pyarrow().sort_by([("k", "ascending")])
    assert g["k"].to_pylist() == exp["k"].to_pylist()
    assert g["count_all"].to_pylist() == exp["count_all"].to_pylist()
    np.testing.assert_allclose(g["v_sum"].to_pylist(),
                               exp["v_sum"].to_pylist(), rtol=1e-9)


def test_dist_group_by_zipf_skew_vs_jax(ctx, jctx, rng):
    """Zipf(1.5) keys: one exchanged row per (shard, distinct key), so the
    skew cannot fill a bucket."""
    n = 1 << 13
    z = rng.zipf(1.5, n).astype(np.int64) % 1000
    t = pa.table({"k": pa.array(z), "v": pa.array(rng.integers(0, 10, n))})
    got, want = _both(ctx, jctx, t, ["k"],
                      [("sum", "v"), ("min", "v"), ("max", "v"),
                       ("mean", "v")], max_groups_per_shard=512)
    _assert_same_per_shard(got, want, t, ["k"], float_cols=("v_mean",))
    exp = t.group_by("k").aggregate(
        [("v", "sum"), ("v", "min"), ("v", "max")]).sort_by(
        [("k", "ascending")])
    g = got.to_pyarrow().sort_by([("k", "ascending")])
    for c in ("k", "v_sum", "v_min", "v_max"):
        assert g[c].to_pylist() == exp[c].to_pylist(), c


def test_dist_group_by_single_hot_key_vs_jax(ctx, jctx, rng):
    n = 1 << 12
    t = pa.table({"k": pa.array(np.zeros(n, np.int64)),
                  "v": pa.array(rng.integers(0, 100, n))})
    got, want = _both(ctx, jctx, t, ["k"], [("sum", "v"), ("count_all",)],
                      max_groups_per_shard=16)
    _assert_same_per_shard(got, want, t, ["k"])
    assert got.num_rows == 1 and len(got.batches) == 1
    assert got.to_pydict() == {"k": [0], "count_all": [n],
                               "v_sum": [int(t["v"].to_numpy().sum())]}


def test_dist_group_by_of_the_multichip_entry_vs_jax(ctx, jctx):
    """The group-by of ``dryrun_multichip``: 64 rows a shard, 8 keys,
    pre_filter v > -3."""
    rng = np.random.default_rng(0)
    n = 64 * N
    cols = {"k": rng.integers(0, 8, n).astype(np.int64),
            "v": rng.standard_normal(n)}
    aggs = [("sum", "v"), ("count_all",)]
    got = ctx.group_by(batch_from_numpy(cols, device="cpu", capacity=n),
                       ["k"], aggs, max_groups_per_shard=32,
                       pre_filter=field("v") > -3.0)
    want = jctx.group_by(at.batch(cols, capacity=n), ["k"], aggs,
                         max_groups_per_shard=32,
                         pre_filter=jfield("v") > -3.0)
    _assert_same_per_shard(got, want, pa.table(cols), ["k"],
                           float_cols=("v_sum",))
    totals = dict(zip(got.to_pydict()["k"], got.to_pydict()["count_all"]))
    for k in range(8):
        assert totals[k] == int(((cols["k"] == k) & (cols["v"] > -3.0)).sum())


def test_entry_distributed_vs_jax(jctx):
    """The port's entry point (w > 0 as pre_filter; sum(v), min(w),
    count_all) against the JAX package on the same columns."""
    step, (b,) = entry_distributed("cpu", N, 4096, 300, 512, 3)
    got = step(b)
    cols = example_columns_generic(4096, 300, 3)
    want = jctx.group_by(at.batch(cols), ["k"],
                         [("sum", "v"), ("min", "w"), ("count_all",)],
                         max_groups_per_shard=512,
                         pre_filter=jfield("w") > 0)
    _assert_same_per_shard(got, want, pa.table(cols), ["k"],
                           float_cols=("v_sum",))
    assert len(got.batches) == N and got.num_rows == want.num_rows > 250


def test_dist_group_by_null_keys_and_values_vs_jax(ctx, jctx, rng):
    n = 3000
    t = pa.table({
        "k": pa.array(rng.integers(-4, 40, n), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.2),
        "w": pa.array(rng.integers(-(1 << 62), 1 << 62, n),
                      mask=rng.random(n) < 0.2)})
    aggs = [("sum", "v"), ("count", "v"), ("min", "w"), ("max", "w"),
            ("sum", "w"), ("mean", "v"), ("count_all",)]
    got, want = _both(ctx, jctx, t, ["k"], aggs, max_groups_per_shard=64)
    _assert_same_per_shard(got, want, t, ["k"],
                           float_cols=("v_sum", "v_mean"))
    assert got.to_pydict()["k"].count(None) == 1


def test_dist_group_by_two_column_key_vs_jax(ctx, jctx, rng):
    n = 5000
    t = pa.table({
        "a": pa.array(rng.integers(0, 12, n)),
        "b": pa.array(rng.integers(0, 5, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.standard_normal(n))})
    got, want = _both(ctx, jctx, t, ["a", "b"],
                      [("sum", "v"), ("count_all",)],
                      max_groups_per_shard=128)
    _assert_same_per_shard(got, want, t, ["a", "b"], float_cols=("v_sum",))
    assert got.num_rows == t.group_by(["a", "b"]).aggregate([]).num_rows


def test_dist_group_by_unsigned_sums_vs_jax(ctx, jctx, rng):
    """Sums of unsigned columns (uint64 out) through consume, the state-row
    exchange and the merge: totals past 2^63, equal bit for bit."""
    n = 2048
    t = pa.table({
        "k": pa.array(rng.integers(0, 9, n)),
        "a": pa.array(rng.integers(0, 1 << 32, n, dtype=np.uint32)),
        "b": pa.array(rng.integers(1 << 61, 1 << 64, n, dtype=np.uint64),
                      mask=rng.random(n) < 0.1)})
    got, want = _both(ctx, jctx, t, ["k"], [("sum", "a"), ("sum", "b")],
                      max_groups_per_shard=16)
    _assert_same_per_shard(got, want, t, ["k"])
    assert got.to_pyarrow()["b_sum"].type == pa.uint64()
    sums = {}
    for k, b in zip(t["k"].to_pylist(), t["b"].to_pylist()):
        sums[k] = (sums.get(k, 0) + (b or 0)) % (1 << 64)
    d = got.to_pydict()
    assert dict(zip(d["k"], d["b_sum"])) == sums
    assert max(d["b_sum"]) > (1 << 63)


def _stream(rng, n, morsel):
    t = pa.table({"k": pa.array(rng.integers(0, 200, n)),
                  "v": pa.array(rng.integers(-50, 50, n))})
    return t, [t.slice(i, morsel).combine_chunks().to_batches()[0]
               for i in range(0, n, morsel)]


_STREAM_AGGS = [("sum", "v"), ("count", "v"), ("min", "v")]


def test_dist_group_by_streaming_vs_jax(ctx, jctx, rng):
    """Streaming consume over several morsels, then one exchange + merge."""
    t, morsels = _stream(rng, 1 << 13, 1 << 11)
    assert len(morsels) > 1
    schema = batch_from_pyarrow(morsels[0], device="cpu").schema
    dgb = DistGroupBy(ctx, schema, ["k"], _STREAM_AGGS,
                      max_groups_per_shard=256)
    jdgb = JDistGroupBy(jctx, at.Batch.from_pyarrow(morsels[0]).schema,
                        ["k"], _STREAM_AGGS, max_groups_per_shard=256)
    state, jstate = dgb.init_state(), jdgb.init_state()
    for rb in morsels:
        state = dgb.consume(state, batch_from_pyarrow(rb, device="cpu"))
        jstate = jdgb.consume(jstate, at.Batch.from_pyarrow(rb))
    got, want = dgb.finalize_table(state), jdgb.finalize_table(jstate)
    _assert_same_per_shard(got, want, t, ["k"])
    exp = t.group_by("k").aggregate(
        [("v", "sum"), ("v", "count"), ("v", "min")]).sort_by(
        [("k", "ascending")])
    g = got.to_pyarrow().sort_by([("k", "ascending")])
    for c in ("k", "v_sum", "v_count", "v_min"):
        assert g[c].to_pylist() == exp[c].to_pylist(), c


def test_state_carried_across_the_exchange_both_ways(ctx, jctx, rng):
    """JAX consumes, the port exchanges + merges (``state_from_numpy``);
    the port consumes, JAX exchanges + merges (``state_to_numpy``). Both
    give the JAX package's own result, and the carried state is the port's
    own state leaf for leaf."""
    t, morsels = _stream(rng, 1 << 12, 1 << 11)
    schema = batch_from_pyarrow(morsels[0], device="cpu").schema
    dgb = DistGroupBy(ctx, schema, ["k"], _STREAM_AGGS,
                      max_groups_per_shard=256)
    jdgb = JDistGroupBy(jctx, at.Batch.from_pyarrow(morsels[0]).schema,
                        ["k"], _STREAM_AGGS, max_groups_per_shard=256)
    state, jstate = dgb.init_state(), jdgb.init_state()
    for rb in morsels:
        state = dgb.consume(state, batch_from_pyarrow(rb, device="cpu"))
        jstate = jdgb.consume(jstate, at.Batch.from_pyarrow(rb))
    want = jdgb.finalize_table(jstate)

    jleaves = tuple(np.asarray(x) for x in jstate)
    carried = dist_agg.state_from_numpy(dgb, jleaves)
    assert len(carried) == N
    _assert_same_per_shard(dgb.finalize_table(carried), want, t, ["k"])

    ours = dist_agg.state_to_numpy(dgb, state)
    assert len(ours) == len(jleaves)
    for i, (a, b) in enumerate(zip(ours, jleaves)):
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, i
    used = np.asarray(jleaves[1]) >= 0          # table_gid: slots in use
    np.testing.assert_array_equal(ours[0][used], jleaves[0][used])
    for a, b in zip(ours[1:4], jleaves[1:4]):
        np.testing.assert_array_equal(a, b)
    back = jdgb.finalize_table(tuple(jnp.asarray(x) for x in ours))
    _assert_same_per_shard(dgb.finalize_table(state), back, t, ["k"])
    _assert_same_per_shard(dgb.finalize_table(state), want, t, ["k"])


def test_raw_row_fallback_vs_jax(ctx, jctx, rng):
    """The raw-row shuffle branch, called directly (every ported aggregator
    is row-shaped, so ``group_by`` never takes it by itself). The JAX
    package takes it for count_distinct: keys, their shards and their order
    depend on the keys alone, so ``k`` and ``count_all`` must be equal per
    shard and in row order."""
    n = 4096
    t = pa.table({"k": pa.array(rng.integers(0, 20, n)),
                  "v": pa.array(rng.integers(0, 5, n))})
    rb = t.to_batches()[0]
    got = ctx.group_by_raw_rows(batch_from_pyarrow(rb, device="cpu"), ["k"],
                                [("count_all",), ("sum", "v")],
                                max_groups_per_shard=64,
                                pre_filter=field("v") > 0)
    want = jctx.group_by(at.Batch.from_pyarrow(rb), ["k"],
                         [("count_all",), ("count_distinct", "v")],
                         max_groups_per_shard=64,
                         pre_filter=jfield("v") > 0)
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        for c in ("k", "count_all"):
            assert gb.to_pydict()[c] == wb.to_pydict()[c]
    sel = t.filter(pa.compute.greater(t["v"], 0))
    exp = sel.group_by("k").aggregate([("v", "sum")]).sort_by("k")
    g = got.to_pyarrow().sort_by("k")
    assert g["v_sum"].to_pylist() == exp["v_sum"].to_pylist()
    # the state-row path gives the same groups (on other shards: its seed
    # differs)
    fast = ctx.group_by(batch_from_pyarrow(rb, device="cpu"), ["k"],
                        [("count_all",), ("sum", "v")],
                        max_groups_per_shard=64, pre_filter=field("v") > 0)
    assert fast.to_pyarrow().sort_by("k").equals(g)


def test_raw_row_fallback_retries_at_doubled_capacities(ctx, rng,
                                                        monkeypatch):
    """Skewed keys and a group table of 2 slots a shard: the error flag
    comes back, and the call runs again with the bucket factor and the
    group capacity doubled until every shard's groups fit. (A bucket of
    bucket_factor >= 1 local capacities cannot fill: a shard has no more
    rows than that.)"""
    n = 4096
    k = np.where(rng.random(n) < 0.9, 0, rng.integers(0, 16, n))
    t = pa.table({"k": pa.array(k), "v": pa.array(rng.standard_normal(n))})
    calls = []
    inner = DistContext.group_by_raw_rows

    def counted(self, b, keys, aggs, max_groups_per_shard=1 << 14,
                pre_filter=None, bucket_factor=2):
        calls.append((bucket_factor, max_groups_per_shard))
        return inner(self, b, keys, aggs, max_groups_per_shard, pre_filter,
                     bucket_factor)

    monkeypatch.setattr(DistContext, "group_by_raw_rows", counted)
    got = ctx.group_by_raw_rows(
        batch_from_pyarrow(t.to_batches()[0], device="cpu"), ["k"],
        [("count_all",)], max_groups_per_shard=2, bucket_factor=1)
    assert calls[:2] == [(1, 2), (2, 4)] and len(calls) <= 4
    exp = t.group_by("k").aggregate([([], "count_all")]).sort_by("k")
    assert got.to_pyarrow().sort_by("k").equals(exp)


def test_too_many_groups_on_a_shard_raises(ctx, rng):
    b = batch_from_numpy({"k": rng.integers(0, 500, 4096),
                          "v": rng.standard_normal(4096)}, device="cpu")
    with pytest.raises(RuntimeError, match="max_groups_per_shard"):
        ctx.group_by(b, ["k"], [("sum", "v")], max_groups_per_shard=16)


def test_no_rows_gives_an_empty_table(ctx):
    b = batch_from_numpy({"k": np.zeros(0, np.int64),
                          "v": np.zeros(0, np.float64)}, device="cpu",
                         capacity=16)
    out = ctx.group_by(b, ["k"], [("sum", "v")], max_groups_per_shard=8)
    assert out.num_rows == 0 and len(out.batches) == 1
    assert out.column_names == ("k", "v_sum")
    assert out.to_pydict() == {"k": [], "v_sum": []}


def test_join_and_sort_by_name_their_queue_items(ctx):
    with pytest.raises(NotImplementedError, match="A6"):
        ctx.join(None, None, None)
    with pytest.raises(NotImplementedError, match="A5"):
        ctx.sort_by(None, [])


def test_table_core():
    """``Table`` as far as a group-by result needs it."""
    import arrow_tpu_torch as att
    a = batch_from_numpy({"x": np.arange(3), "y": np.ones(3)}, device="cpu",
                         capacity=8)
    b = batch_from_numpy({"x": np.arange(3, 5), "y": np.zeros(2)},
                         device="cpu")
    t = att.Table(a.schema, [a, b])
    assert (t.num_rows, t.num_columns) == (5, 2)
    assert t.column_names == ("x", "y")
    assert t.to_pydict() == {"x": [0, 1, 2, 3, 4],
                             "y": [1.0, 1.0, 1.0, 0.0, 0.0]}
    one = t.combine_chunks()
    assert len(one.batches) == 1 and one.batches[0].capacity == 5
    assert one.equals(t) and t.equals(t.to_pyarrow())
    assert att.Table(a.schema, []).to_pyarrow().num_rows == 0
    e = att.empty_batch(a.schema, device="cpu")
    assert len(e) == 0 and e.capacity == 16 and e.to_pyarrow().num_rows == 0
