"""Port parity: the plan nodes' ``dist=`` option (``HashJoinNodeOptions``
and ``AggregateNodeOptions`` over a ``DistContext``) against the port's
one-device plan and against the JAX package's ``dist=`` plan, as the JAX
package's ``test_plan_dist_join_streaming``, ``test_plan_dist_join_chained``
and ``test_plan_dist_aggregate_streaming`` write them. The JAX side runs on
the 8-virtual-device CPU mesh, the port on 8 logical CPU shards. Joins
compare as sorted tables (every column is an integer), the aggregate as
the table sorted by its key."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu.acero as jacero
import arrow_tpu_torch as att
import arrow_tpu_torch.acero as tacero
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.compute.expressions import field as tfield
from arrow_tpu_torch.parallel import DistContext
from test_torch_acero import _drop_jax_executables  # noqa: F401 (autouse)

N = 8


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _sorted_dict(t: pa.Table):
    u = [f"c{i}" for i in range(t.num_columns)]
    return t.rename_columns(u).sort_by(
        [(x, "ascending") for x in u]).to_pydict()


def _source(A, t: pa.Table, rows: int):
    if A is tacero:
        t = att.Table.from_pyarrow(t, max_rows_per_batch=rows, device="cpu")
        return A.Declaration("table_source", A.TableSourceNodeOptions(t))
    return A.Declaration("table_source",
                         A.TableSourceNodeOptions(t, max_batch_rows=rows))


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "left anti", "right semi"])
def test_plan_dist_join_streaming_vs_jax(ctx, jctx, rng, join_type):
    """hashjoin with ``dist=``: the build batches shuffle and accumulate,
    the probe batches stream; equal to the one-device plan and to the JAX
    package's dist plan."""
    nl, nr = 5000, 800
    lt = pa.table({"k": pa.array(rng.integers(0, 400, nl)),
                   "lv": pa.array(rng.integers(0, 1000, nl))})
    rt = pa.table({"k": pa.array(rng.integers(0, 400, nr)),
                   "rv": pa.array(rng.integers(0, 1000, nr))})

    def run(A, f, dist):
        left = A.Declaration("filter", A.FilterNodeOptions(f("lv") < 700),
                             [_source(A, lt, 1024)])
        d = A.Declaration("hashjoin", A.HashJoinNodeOptions(
            join_type, ["k"], ["k"], max_build_rows=1 << 11,
            fanout_capacity=1 << 13, output_suffix_for_left="_l",
            output_suffix_for_right="_r", dist=dist),
            [left, _source(A, rt, 256)])
        return d.to_table()

    got = run(tacero, tfield, ctx)
    assert all(len(b) for b in got.batches)
    exp = _sorted_dict(got.to_pyarrow())
    assert exp == _sorted_dict(run(tacero, tfield, None).to_pyarrow())
    assert exp == _sorted_dict(run(jacero, jfield, jctx).to_pyarrow())


def test_plan_dist_join_chained_vs_jax(ctx, jctx, rng):
    """Two chained dist joins: the second consumes the first's per-shard
    output batches (validity present) against a table source's (none):
    the shuffle must co-partition both alike."""
    na, nb, nc = 4000, 900, 700
    ta_ = pa.table({"k": pa.array(rng.integers(0, 300, na)),
                    "av": pa.array(rng.integers(0, 1000, na))})
    tb_ = pa.table({"k": pa.array(rng.integers(0, 300, nb)),
                    "j": pa.array(rng.integers(0, 200, nb)),
                    "bv": pa.array(rng.integers(0, 1000, nb))})
    tc_ = pa.table({"j": pa.array(rng.integers(0, 200, nc)),
                    "cv": pa.array(rng.integers(0, 1000, nc))})

    def run(A, d1, d2):
        bc = A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", ["j"], ["j"], max_build_rows=1 << 11,
            fanout_capacity=1 << 14, output_suffix_for_left="_b",
            output_suffix_for_right="_c", dist=d1),
            [_source(A, tb_, 256), _source(A, tc_, 256)])
        abc = A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", ["k"], ["k"], max_build_rows=1 << 13,
            fanout_capacity=1 << 16, output_suffix_for_left="_a",
            output_suffix_for_right="_bc", dist=d2),
            [_source(A, ta_, 512), bc])
        return _sorted_dict(abc.to_table().to_pyarrow())

    exp = run(tacero, None, None)
    assert run(tacero, ctx, ctx) == exp
    assert run(tacero, ctx, None) == exp
    assert run(jacero, jctx, jctx) == exp


def test_plan_dist_aggregate_streaming_vs_jax(ctx, jctx, rng):
    """aggregate with ``dist=``: per-shard pre-aggregation of each batch,
    one state-row exchange; one batch per shard with groups, each group on
    one shard."""
    n = 8192
    t = pa.table({"k": pa.array(rng.integers(0, 97, n)),
                  "v": pa.array(rng.integers(0, 1000, n))})

    def run(A, dist):
        d = A.Declaration("aggregate", A.AggregateNodeOptions(
            [("sum", "v"), ("count_all",)], keys=["k"], max_groups=256,
            dist=dist), [_source(A, t, 1024)])
        return d.to_table()

    got = run(tacero, ctx)
    assert len(got.batches) == N
    g = got.to_pyarrow().sort_by([("k", "ascending")])
    assert g.num_rows == 97
    assert g.to_pydict() == \
        run(tacero, None).to_pyarrow().sort_by([("k", "ascending")]) \
        .to_pydict()
    want = run(jacero, jctx)
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    assert g.to_pydict() == \
        want.to_pyarrow().sort_by([("k", "ascending")]).to_pydict()


def test_plan_dist_aggregate_raw_row_route(ctx, rng, monkeypatch):
    """The node's branch for aggregators whose state is not one row per
    group (no port aggregator is such yet: they come with ROADMAP A6),
    taken by declaring the states not row-shaped: the input concatenates
    and goes through ``DistContext.group_by``'s raw-row shuffle, equal to
    the one-device plan."""
    from arrow_tpu_torch.ops.hash_aggregate import HashAggregate
    n = 3000
    t = pa.table({"k": pa.array(rng.integers(0, 50, n)),
                  "v": pa.array(rng.standard_normal(n))})

    def run(dist):
        d = tacero.Declaration("aggregate", tacero.AggregateNodeOptions(
            [("mean", "v"), ("min", "v"), ("count_all",)], keys=["k"],
            max_groups=128, dist=dist), [_source(tacero, t, 700)])
        return d.to_table().to_pyarrow().sort_by([("k", "ascending")])

    exp = run(None)
    monkeypatch.setattr(HashAggregate, "supports_state_exchange",
                        property(lambda self: False))
    got = run(ctx)
    assert got["k"].to_pylist() == exp["k"].to_pylist()
    assert got["v_min"].to_pylist() == exp["v_min"].to_pylist()
    assert got["count_all"].to_pylist() == exp["count_all"].to_pylist()
    np.testing.assert_allclose(got["v_mean"].to_pylist(),
                               exp["v_mean"].to_pylist(), rtol=1e-12)
