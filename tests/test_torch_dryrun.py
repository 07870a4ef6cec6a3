"""The port's ``entry.dryrun_multichip`` on 8 logical CPU shards: its five
checks pass (the distributed group-by, join and sort, one hot key, and the
Q3 Declaration with ``dist=``), and its Q3 top 10 equals the JAX package's
``dist=`` Declaration on the same tables over the 8-virtual-device CPU
mesh: keys and order exact, float64 revenue within 1e-12 * sum|rev| +
1e-12 (the two packages add each group's rows in other orders)."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu.acero import (AggregateNodeOptions, AggregateSpec,
                             Declaration, FetchNodeOptions,
                             FilterNodeOptions, HashJoinNodeOptions,
                             OrderByNodeOptions, ProjectNodeOptions,
                             TableSourceNodeOptions)
from arrow_tpu.compute.expressions import field, literal
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.entry import dryrun_multichip, entry_q3_dist, \
    example_columns_q3
from test_torch_acero import _drop_jax_executables  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(8, device="cpu")


def _jax_q3(li, od, cu, ctx, max_groups=256):
    """``__graft_entry__.dryrun_multichip``'s Q3 Declaration with
    ``dist=ctx`` over the numpy columns, in 64-row batches."""
    li_t, od_t, cu_t = (at.Table.from_pyarrow(pa.table(c),
                                              max_rows_per_batch=64)
                        for c in (li, od, cu))
    nc, no = len(cu["c_custkey"]), len(od["o_orderkey"])
    co = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        left_output=["o_orderkey", "o_date"], right_output=[],
        max_build_rows=max(nc, 16), dist=ctx), inputs=[
            Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(od_t)),
                Declaration("filter", FilterNodeOptions(
                    field("o_date") < literal(25)))]),
            Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(cu_t)),
                Declaration("filter", FilterNodeOptions(
                    field("c_seg") == literal(1)))])])
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_orderkey", "l_price", "l_disc"],
            right_output=["o_date"], max_build_rows=max(no, 16), dist=ctx),
            inputs=[Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(li_t)),
                Declaration("filter", FilterNodeOptions(
                    field("l_ship") > literal(40)))]), co]),
        Declaration("project", ProjectNodeOptions(
            [field("l_orderkey"),
             field("l_price") * (literal(1.0) - field("l_disc")),
             field("o_date")], ["l_orderkey", "rev", "o_date"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "rev", name="revenue")],
            keys=["l_orderkey", "o_date"], max_groups=max_groups,
            dist=ctx)),
        Declaration("order_by", OrderByNodeOptions(
            [("revenue", "descending"), ("l_orderkey", "ascending")])),
        Declaration("fetch", FetchNodeOptions(0, 10)),
    ]).to_table().to_pyarrow()


def _assert_top10_equal(got: pa.Table, want: pa.Table):
    """Keys, dates and order exact; revenue within 1e-12 * sum|rev| +
    1e-12 (rev is positive: its sum of |rev| is itself)."""
    assert got.num_rows == want.num_rows == 10
    assert got["l_orderkey"].to_pylist() == want["l_orderkey"].to_pylist()
    assert got["o_date"].to_pylist() == want["o_date"].to_pylist()
    g = np.asarray(got["revenue"], dtype=np.float64)
    w = np.asarray(want["revenue"], dtype=np.float64)
    assert (np.abs(g - w) <= 1e-12 * w + 1e-12).all(), (g, w)


def test_dryrun_multichip_passes(dryrun):
    assert dryrun["group_by"].num_rows == 8
    assert dryrun["join"].num_rows == 243
    assert dryrun["sort"].num_rows == 512
    assert dryrun["skew"].num_rows == 1
    assert dryrun["q3"].num_rows == 10


def test_dryrun_q3_vs_jax_dist_plan(dryrun):
    li, od, cu = dryrun["q3_columns"]
    want = _jax_q3(li, od, cu, JDistContext())
    _assert_top10_equal(dryrun["q3"].to_pyarrow(), want)


def test_entry_q3_dist_vs_jax_dist_plan():
    """``entry_q3_dist`` on its own columns (seed 7: 768 lineitem rows in
    64-row batches, 256 groups a shard) against the JAX package's plan with
    ``dist=`` on the same tables."""
    step, tables = entry_q3_dist("cpu", 8, 768, 7, 256, 64)
    got = step(*tables).to_pyarrow()
    li, od, cu = example_columns_q3(768, 7)
    _assert_top10_equal(got, _jax_q3(li, od, cu, JDistContext()))
