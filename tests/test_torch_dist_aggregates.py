"""Port parity: the other aggregators across shards. Row-shaped states
(product, any, all, variance, stddev, skew, kurtosis; first / last / one
with their rows) through ``DistGroupBy``'s state-row exchange against the
JAX package's on its 8-virtual-device CPU mesh and carried between the two
packages' states; count_distinct and approximate_median through
``DistContext.group_by``'s raw-row shuffle against the JAX package, with
the retry that grows ``buffer_rows`` and ``max_pairs``; the aggregate node
with ``dist=``. The port runs 8 logical shards on the CPU.

Per shard and in row order where the two packages share the shards' layout;
integers, bools, first / last / one and medians exact, float64 results
within 1e-9 relative. The values compared with the JAX package's skew and
kurtosis have mean 0: its raw power sums lose digits as the mean grows
(ROADMAP C27, held against numpy in ``test_torch_aggregates``).
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu.acero as jacero
import arrow_tpu_torch as att
import arrow_tpu_torch.acero as tacero
from arrow_tpu.ops.agg_options import CountOptions as JCount
from arrow_tpu.ops.agg_options import VarianceOptions as JVariance
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu.parallel import DistGroupBy as JDistGroupBy
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import entry_dist_groupby_q6, entry_groupby_q6, \
    example_columns_q6
from arrow_tpu_torch.ops.agg_options import CountOptions, VarianceOptions
from arrow_tpu_torch.ops.aggregates_order import TDigestOptions
from arrow_tpu_torch.parallel import DistContext, DistGroupBy, context, \
    dist_agg

N = 8
F64_RTOL = 1e-9


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _table(rng, n=4096, nkeys=61):
    return pa.table({
        "k": pa.array(rng.integers(0, nkeys, n), mask=rng.random(n) < 0.02),
        "v": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-2, 3, n)),
        "b": pa.array(rng.random(n) < 0.7, mask=rng.random(n) < 0.1)})


def _same_shards(got, want, float_cols=()):
    """Port Table and JAX Table: the same shards hold rows, each in the
    same row order with the same values (floats of ``float_cols`` within
    F64_RTOL relative)."""
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        g, w = gb.to_pyarrow(), wb.to_pyarrow()
        assert g.schema.names == w.schema.names
        for name in w.schema.names:
            a, b = g[name].to_pylist(), w[name].to_pylist()
            if name in float_cols:
                assert [x is None for x in a] == [x is None for x in b], name
                np.testing.assert_allclose(
                    [np.nan if x is None else x for x in a],
                    [np.nan if x is None else x for x in b],
                    rtol=F64_RTOL, equal_nan=True, err_msg=name)
            else:
                assert a == b, name


_ROW_AGGS = {
    "product": (("product", "i"), False),
    "any": (("any", "b"), False),
    "all": (("all", "b"), False),
    "variance": (("variance", "v"), True),
    "stddev": (("stddev", "v", "ddof1"), True),
    "skew": (("skew", "v"), True),
    "kurtosis": (("kurtosis", "v"), True),
}


def _spec(agg, J):
    fn, col = agg[0], agg[1]
    opts = None
    if len(agg) > 2:
        opts = (JVariance if J else VarianceOptions)(ddof=1)
    return (fn, col, opts)


@pytest.mark.parametrize("name", list(_ROW_AGGS))
def test_state_row_aggregators_through_dist_group_by_vs_jax(ctx, jctx, rng,
                                                            name):
    """Pre-aggregated state rows cross the exchange and merge: the same
    groups on the same shards as the JAX package, in the same order."""
    agg, is_float = _ROW_AGGS[name]
    t = _table(rng)
    rb = t.to_batches()[0]
    aggs_t = [("count_all",), _spec(agg, False)]
    aggs_j = [("count_all",), _spec(agg, True)]
    got = ctx.group_by(batch_from_pyarrow(rb, device="cpu"), ["k"], aggs_t,
                       max_groups_per_shard=64)
    want = jctx.group_by(at.Batch.from_pyarrow(rb), ["k"], aggs_j,
                         max_groups_per_shard=64)
    out = f"{agg[1]}_{agg[0]}"
    _same_shards(got, want, (out,) if is_float else ())


def test_dist_group_by_streaming_state_carried_both_ways(ctx, jctx, rng):
    """Two batches streamed into ``DistGroupBy``: the JAX package's
    per-shard state carried into the port (``state_from_numpy``: its raw
    power sums become centred moments) and the port's carried back
    (``state_to_numpy``) give the JAX package's groups."""
    t = _table(rng, 4096)
    rbs = t.to_batches(max_chunksize=2048)
    aggs_t = [("any", "b"), ("product", "i"), ("stddev", "v",
                                                VarianceOptions(ddof=1)),
              ("kurtosis", "v"), ("count_all",)]
    aggs_j = [("any", "b"), ("product", "i"), ("stddev", "v",
                                               JVariance(ddof=1)),
              ("kurtosis", "v"), ("count_all",)]
    schema = batch_from_pyarrow(rbs[0], device="cpu").schema
    dgb = DistGroupBy(ctx, schema, ["k"], aggs_t, max_groups_per_shard=128)
    jdgb = JDistGroupBy(jctx, at.Batch.from_pyarrow(rbs[0]).schema, ["k"],
                        aggs_j, max_groups_per_shard=128)
    st, jst = dgb.init_state(), jdgb.init_state()
    for rb in rbs:
        st = dgb.consume(st, batch_from_pyarrow(rb, device="cpu"))
        jst = jdgb.consume(jst, at.Batch.from_pyarrow(rb))
    want = jdgb.finalize_table(jst)
    floats = ("v_stddev", "v_kurtosis")
    _same_shards(dgb.finalize_table(st), want, floats)
    carried = dist_agg.state_from_numpy(dgb, tuple(np.asarray(x)
                                                   for x in jst))
    _same_shards(dgb.finalize_table(carried), want, floats)
    ours = dist_agg.state_to_numpy(dgb, st)
    assert [x.shape for x in ours] == [np.asarray(x).shape for x in jst]
    back = jdgb.finalize_table(tuple(jnp.asarray(x) for x in ours))
    _same_shards(back, want, floats)


@pytest.mark.parametrize("fn", ["first", "last", "one"])
def test_first_last_one_through_dist_group_by(ctx, rng, fn):
    """Each key's rows in one shard's block: the state rows carry (row,
    value), and the merged result is pyarrow's first / last over the
    stream (``use_threads=False``, ROADMAP C1); "one" is one of the
    group's values."""
    n = 4096
    block = np.arange(n) // (n // N)
    k = block * 10 + rng.integers(0, 10, n)
    v = rng.standard_normal(n)
    mask = rng.random(n) < 0.2
    t = pa.table({"k": k, "v": pa.array(v, mask=mask)})
    got = ctx.group_by(batch_from_pyarrow(t.to_batches()[0], device="cpu"),
                       ["k"], [(fn, "v")], max_groups_per_shard=128) \
        .to_pyarrow().sort_by("k")
    if fn == "one":
        for key, val in zip(got["k"].to_pylist(),
                            got["v_one"].to_pylist()):
            assert val in v[(k == key) & ~mask]
        return
    want = t.group_by("k", use_threads=False).aggregate([("v", fn)]) \
        .sort_by("k")
    assert got.to_pydict() == want.to_pydict()


def test_raw_row_aggregators_vs_jax(ctx, jctx, rng):
    """count_distinct and approximate_median are not row-shaped: both
    packages shuffle the raw rows by key, so the same groups land on the
    same shards in the same order, with the same counts and medians."""
    t = _table(rng)
    rb = t.to_batches()[0]
    got = ctx.group_by(batch_from_pyarrow(rb, device="cpu"), ["k"],
                       [("count_distinct", "i"), ("approximate_median", "v"),
                        ("count_distinct", "b", CountOptions("all")),
                        ("stddev", "v", VarianceOptions(ddof=1))],
                       max_groups_per_shard=64)
    want = jctx.group_by(at.Batch.from_pyarrow(rb), ["k"],
                         [("count_distinct", "i"), ("approximate_median",
                                                    "v"),
                          ("count_distinct", "b", JCount("all")),
                          ("stddev", "v", JVariance(ddof=1))],
                         max_groups_per_shard=64)
    _same_shards(got, want, ("v_stddev",))


def test_raw_row_retry_grows_buffer_rows_and_max_pairs(ctx, rng,
                                                       monkeypatch):
    """A median buffer and a pair table too small for what a shard
    receives: the shards' aggregator errors come back, and the call runs
    again with ``buffer_rows`` grown to the rows a shard receives and
    ``max_pairs`` doubled, until the answers are numpy's."""
    n = 4096
    k = rng.integers(0, 5, n)
    w = rng.integers(0, 10**6, n)
    v = rng.standard_normal(n)
    t = pa.table({"k": k, "w": w, "v": v})
    calls = []
    inner = DistContext.group_by_raw_rows

    def counted(self, b, keys, aggs, *a, **kw):
        calls.append([getattr(s.options, "buffer_rows", None) or
                      getattr(s.options, "max_pairs", None)
                      for s in aggs])
        return inner(self, b, keys, aggs, *a, **kw)

    monkeypatch.setattr(DistContext, "group_by_raw_rows", counted)
    pairs = CountOptions()
    pairs.max_pairs = 64
    got = ctx.group_by(
        batch_from_pyarrow(t.to_batches()[0], device="cpu"), ["k"],
        [("approximate_median", "v", TDigestOptions(buffer_rows=256)),
         ("count_distinct", "w", pairs)], max_groups_per_shard=8) \
        .to_pyarrow().sort_by("k")
    assert calls[0] == [256, 64]
    assert calls[1][0] == N * 2 * (n // N) and calls[1][1] == 128
    assert len(calls) <= 6
    assert got["v_approximate_median"].to_pylist() == \
        [np.median(v[k == key]) for key in range(5)]
    assert got["w_count_distinct"].to_pylist() == \
        [len(np.unique(w[k == key])) for key in range(5)]


def test_raw_row_full_buffer_that_cannot_grow_raises(ctx, rng, monkeypatch):
    """Past the largest buffer the retry allows, the call raises and names
    ``buffer_rows``; it returns no wrong median (the JAX package does:
    ROADMAP C25)."""
    monkeypatch.setattr(context, "_MAX_BUFFER_ROWS", 512)
    b = batch_from_pyarrow(pa.table({
        "k": rng.integers(0, 3, 4096), "v": rng.standard_normal(4096)})
        .to_batches()[0], device="cpu")
    with pytest.raises(RuntimeError, match="buffer_rows"):
        ctx.group_by(b, ["k"], [("approximate_median", "v",
                                 TDigestOptions(buffer_rows=256))])


@pytest.mark.parametrize("aggs", ["state_rows", "raw_rows"])
def test_aggregate_node_with_dist(ctx, rng, aggs):
    """The aggregate node with ``dist=``: row-shaped aggregators take the
    state-row exchange, the median the raw-row shuffle (the input
    accumulated); both give the one-device plan's groups."""
    t = _table(rng, 6000)
    specs = [("any", "b"), ("variance", "v"), ("count_all",)] \
        if aggs == "state_rows" else \
        [("approximate_median", "v"), ("count_distinct", "i"),
         ("all", "b")]

    def run(dist):
        src = att.Table.from_pyarrow(t, max_rows_per_batch=1024,
                                     device="cpu")
        d = tacero.Declaration("aggregate", tacero.AggregateNodeOptions(
            specs, keys=["k"], max_groups=128, dist=dist), [
            tacero.Declaration("table_source",
                               tacero.TableSourceNodeOptions(src))])
        return d.to_table()

    got = run(ctx)
    assert len(got.batches) > 1
    one = run(None).to_pyarrow().sort_by("k").to_pydict()
    g = got.to_pyarrow().sort_by("k").to_pydict()
    assert g.keys() == one.keys()
    for name in g:
        if name == "v_variance":
            np.testing.assert_allclose(g[name], one[name], rtol=F64_RTOL)
        else:
            assert g[name] == one[name], name


def test_q6_entries_vs_numpy_and_jax(jctx):
    """``entry_groupby_q6`` and ``entry_dist_groupby_q6`` (4 logical
    shards) at 20,000 rows against numpy's median and std(ddof=1) per
    (id4, id5), and their medians against the JAX package's distributed
    group-by of the same columns."""
    n = 20000
    cols = example_columns_q6(n, 3)
    step, (tbl,) = entry_groupby_q6("cpu", n, 3)
    one = step(tbl).to_pyarrow().sort_by([("id4", "ascending"),
                                          ("id5", "ascending")])
    dstep, (b,) = entry_dist_groupby_q6("cpu", 4, n, 3)
    dist = dstep(b).to_pyarrow().sort_by([("id4", "ascending"),
                                          ("id5", "ascending")])
    code = (cols["id4"].astype(np.int64) - 1) * 100 + cols["id5"] - 1
    keys = np.unique(code)
    med = [np.median(cols["v3"][code == c]) for c in keys]
    sd = [np.std(cols["v3"][code == c], ddof=1) for c in keys]
    for out in (one, dist):
        got_code = (np.array(out["id4"].to_pylist()) - 1) * 100 + \
            np.array(out["id5"].to_pylist()) - 1
        assert np.array_equal(got_code, keys)
        np.testing.assert_allclose(out["median_v3"].to_pylist(), med,
                                   rtol=1e-12)
        sd_got = np.array([np.nan if x is None else x
                           for x in out["sd_v3"].to_pylist()])
        np.testing.assert_allclose(sd_got, sd, rtol=F64_RTOL)
    jt = pa.table({"id4": cols["id4"], "id5": cols["id5"],
                   "v3": cols["v3"]})
    jb = at.Batch.from_pyarrow(jt.to_batches()[0])
    jopts = at.compute.TDigestOptions()
    jopts.buffer_rows = 1 << 17
    want = jctx.group_by(jb, ["id4", "id5"], [
        ("approximate_median", "v3", jopts, "median_v3"),
        ("stddev", "v3", JVariance(ddof=1), "sd_v3")]).to_pyarrow() \
        .sort_by([("id4", "ascending"), ("id5", "ascending")])
    # the medians are the JAX package's; its sd comes from raw power sums,
    # which lose digits where a group's spread is small against its mean
    # (ROADMAP C27): the sd is held against numpy above
    assert want["median_v3"].to_pylist() == dist["median_v3"].to_pylist()
    assert want["sd_v3"].is_null().to_pylist() == \
        dist["sd_v3"].is_null().to_pylist()
