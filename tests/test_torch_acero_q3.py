"""Port parity of the Q3-shaped Declaration of ``__graft_entry__.py``
(BASELINE config #5's shape, without ``dist=``) through
``arrow_tpu_torch.acero`` against the JAX package's and against the dry
run's pyarrow oracle: keys and order exact, float64 revenue within
1e-12 * sum|rev| + 1e-12 of the JAX package's, and within 1e-5 * sum|rev|
+ 1e-6 of pyarrow's float32 revenue. Also the aggregate's group-table
doubling past the dry run's 256 groups."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow_tpu as at
from test_torch_acero import JAX, PORT, _assert_equal, _both, _seq, \
    _drop_jax_executables  # noqa: F401 (an autouse fixture)


def _q3_tables(n_devices=8, seed=0):
    """The dry run's inputs (``__graft_entry__.py``): 96 / 24 / 8 rows per
    device of lineitem / orders / customer."""
    rng = np.random.default_rng(seed)
    nl, no, nc = 96 * n_devices, 24 * n_devices, 8 * n_devices
    li = pa.table({
        "l_orderkey": pa.array(rng.integers(0, no, nl)),
        "l_price": pa.array(rng.random(nl).astype(np.float32) * 100),
        "l_disc": pa.array(rng.random(nl).astype(np.float32) * 0.1),
        "l_ship": pa.array(rng.integers(0, 100, nl).astype(np.int32)),
    })
    od = pa.table({
        "o_orderkey": pa.array(np.arange(no, dtype=np.int64)),
        "o_custkey": pa.array(rng.integers(0, nc, no)),
        "o_date": pa.array(rng.integers(0, 50, no).astype(np.int32)),
    })
    cu = pa.table({
        "c_custkey": pa.array(np.arange(nc, dtype=np.int64)),
        "c_seg": pa.array(rng.integers(0, 3, nc).astype(np.int32)),
    })
    return li, od, cu


def _q3(P, li, od, cu, max_groups=256):
    A, f, lit = P.acero, P.field, P.literal
    nc, no = cu.num_rows, od.num_rows
    co = A.Declaration("hashjoin", A.HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        left_output=["o_orderkey", "o_date"], right_output=[],
        max_build_rows=max(nc, 16)), inputs=[
            _seq(P, od, A.Declaration("filter", A.FilterNodeOptions(
                f("o_date") < lit(25)))),
            _seq(P, cu, A.Declaration("filter", A.FilterNodeOptions(
                f("c_seg") == lit(1))))])
    return A.Declaration.from_sequence([
        A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_orderkey", "l_price", "l_disc"],
            right_output=["o_date"], max_build_rows=max(no, 16)), inputs=[
                _seq(P, li, A.Declaration("filter", A.FilterNodeOptions(
                    f("l_ship") > lit(40)))), co]),
        A.Declaration("project", A.ProjectNodeOptions(
            [f("l_orderkey"), f("l_price") * (lit(1.0) - f("l_disc")),
             f("o_date")], ["l_orderkey", "rev", "o_date"])),
        A.Declaration("aggregate", A.AggregateNodeOptions(
            [A.AggregateSpec("sum", "rev", name="revenue")],
            keys=["l_orderkey", "o_date"], max_groups=max_groups)),
        A.Declaration("order_by", A.OrderByNodeOptions(
            [("revenue", "descending"), ("l_orderkey", "ascending")])),
        A.Declaration("fetch", A.FetchNodeOptions(0, 10)),
    ])


def _q3_oracle(li, od, cu):
    """The dry run's pyarrow oracle (float32 revenue, as pyarrow types
    float32 * (1.0f - float32)) and each group's sum of |rev|."""
    cu_f = cu.filter(pc.equal(cu["c_seg"], 1))
    od_f = od.filter(pc.less(od["o_date"], 25))
    li_f = li.filter(pc.greater(li["l_ship"], 40))
    oc = od_f.join(cu_f.select(["c_custkey"]), keys="o_custkey",
                   right_keys="c_custkey", join_type="inner")
    j = li_f.join(oc.select(["o_orderkey", "o_date"]), keys="l_orderkey",
                  right_keys="o_orderkey", join_type="inner")
    rev = pc.multiply(j["l_price"], pc.subtract(pa.scalar(1.0, pa.float32()),
                                                j["l_disc"]))
    return j.append_column("rev", rev).group_by(["l_orderkey", "o_date"]) \
        .aggregate([("rev", "sum")]) \
        .rename_columns(["l_orderkey", "o_date", "revenue"]) \
        .sort_by([("revenue", "descending"),
                  ("l_orderkey", "ascending")]).slice(0, 10)


@pytest.mark.parametrize("seed", [0, 1])
def test_q3_plan_vs_jax_and_pyarrow(seed):
    """The Q3-shaped Declaration without ``dist=``, 64-row batches, the dry
    run's 256 groups: keys and order exact against both, float64 revenue
    within
    1e-12 * sum|rev| + 1e-12 of the JAX package's and within the float32
    tolerance of pyarrow's float32 revenue."""
    li, od, cu = _q3_tables(seed=seed)
    got, want = _both(_q3, li, od, cu)
    assert got.schema.types == want.schema.types == \
        [pa.int64(), pa.int32(), pa.float64()]
    _assert_equal(got.select(["l_orderkey", "o_date"]),
                  want.select(["l_orderkey", "o_date"]))
    g = got["revenue"].to_numpy()
    # revenue is a sum of positive terms: sum|rev| is the revenue itself
    assert (np.abs(g - want["revenue"].to_numpy())
            <= 1e-12 * np.abs(g) + 1e-12).all()
    exp = _q3_oracle(li, od, cu)
    assert got["l_orderkey"].to_pylist() == exp["l_orderkey"].to_pylist()
    assert got["o_date"].to_pylist() == exp["o_date"].to_pylist()
    assert (np.abs(g - exp["revenue"].to_numpy())
            <= 1e-5 * np.abs(g) + 1e-6).all()


def test_q3_plan_group_table_doubles():
    """At 2^13 lineitem rows the aggregate holds about 300 groups, past the
    dry run's 256: the port's node doubles its group table and still
    equals the JAX package's table."""
    from arrow_tpu_torch.entry import entry_q3, example_columns_q3
    step, (li, od, cu) = entry_q3("cpu", 1 << 13, 3, 256, 1 << 11)
    got = step(li, od, cu).to_pyarrow()
    cols = example_columns_q3(1 << 13, 3)
    jt = [at.Table.from_pyarrow(pa.table(c), max_rows_per_batch=1 << 11)
          for c in cols]
    want = _q3(JAX, *jt).to_table().to_pyarrow()
    _assert_equal(got.select(["l_orderkey", "o_date"]),
                  want.select(["l_orderkey", "o_date"]))
    g = got["revenue"].to_numpy()
    assert (np.abs(g - want["revenue"].to_numpy())
            <= 1e-12 * np.abs(g) + 1e-12).all()
    decl = _q3(PORT, li, od, cu)
    node = decl._build()
    list(node.batches())
    agg = node.inputs[0].inputs[0]
    assert agg.factory_name == "aggregate" and agg.ha.max_groups == 512
