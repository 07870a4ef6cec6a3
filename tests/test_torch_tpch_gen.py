"""Port parity: the ``tpch_gen`` node (``acero/nodes.py`` ``TpchGenNode``)
against the JAX package's at SF 0.01: the same tables in the same batches,
and TPC-H Q1 over the generator (filter, project, aggregate, order_by)
equal to the JAX package's plan and to a numpy Q1 of the generated
lineitem. Generated columns are exact; Q1's float sums and means within
1e-12 * sum|x| + 1e-12 per group (the packages sum in other orders)."""

import datetime
import os

import pytest

from test_torch_acero import JAX, PORT, _assert_equal, \
    _drop_jax_executables  # noqa: F401 (an autouse fixture)
from arrow_tpu_torch import entry as E
from arrow_tpu_torch.utils.tpch import tpch_table

SF = 0.01
ROWS = 1 << 14


def _gen(P, name, rows=ROWS):
    opts = P.acero.TpchGenNodeOptions(name, SF, 42, rows)
    if P is PORT:
        opts.device = "cpu"
    return P.acero.Declaration("tpch_gen", opts)


@pytest.mark.parametrize("name", ["lineitem", "orders", "nation"])
def test_tpch_gen_vs_jax(name):
    got = _gen(PORT, name).to_table()
    want = _gen(JAX, name).to_table()
    assert [b.capacity for b in got.batches] == \
        [b.capacity for b in want.batches]
    _assert_equal(got.to_pyarrow(), want.to_pyarrow())
    _assert_equal(got.to_pyarrow(), tpch_table(name, SF, 42))


def _q1(P):
    f, lit = P.field, P.literal
    price = f("l_extendedprice")
    disc_price = price * (lit(1.0) - f("l_discount"))
    keys = ["l_returnflag", "l_linestatus"]
    Spec = P.acero.AggregateSpec
    return P.acero.Declaration.from_sequence([
        _gen(P, "lineitem"),
        P.acero.Declaration("filter", P.acero.FilterNodeOptions(
            f("l_shipdate") <= lit(datetime.date(*E.Q1_SHIPDATE)))),
        P.acero.Declaration("project", P.acero.ProjectNodeOptions(
            [f(k) for k in keys] + [
                f("l_quantity"), price, disc_price,
                disc_price * (lit(1.0) + f("l_tax")), f("l_discount")],
            keys + ["l_quantity", "l_extendedprice", "disc_price",
                    "charge", "l_discount"])),
        P.acero.Declaration("aggregate", P.acero.AggregateNodeOptions([
            Spec("sum", "l_quantity", name="sum_qty"),
            Spec("sum", "l_extendedprice", name="sum_base_price"),
            Spec("sum", "disc_price", name="sum_disc_price"),
            Spec("sum", "charge", name="sum_charge"),
            Spec("mean", "l_quantity", name="avg_qty"),
            Spec("mean", "l_extendedprice", name="avg_price"),
            Spec("mean", "l_discount", name="avg_disc"),
            Spec("count_all", name="count_order")], keys=keys,
            max_groups=16)),
        P.acero.Declaration("order_by", P.acero.OrderByNodeOptions(
            [(k, "ascending") for k in keys]))])


def test_tpch_gen_q1_vs_jax_and_numpy():
    got = _q1(PORT).to_table().to_pydict()
    want = _q1(JAX).to_table().to_pydict()
    oracle = E.q1_numpy(tpch_table("lineitem", SF, 42))
    assert not E.q1_differ(got, oracle)
    assert not E.q1_differ(want, oracle)
    for k in ("l_returnflag", "l_linestatus", "count_order"):
        assert got[k] == want[k]
    # the entry point's plan is this one
    step, args = E.entry_tpch_gen_q1("cpu", SF, 42, ROWS)
    assert step(*args).to_pydict() == got


def test_tpch_gen_projection_pushdown():
    """Under Q1 the plan generates only the seven columns it reads (the
    comment is never drawn) and gives what the unpruned plan gives."""
    from arrow_tpu_torch.acero.plan import prune_columns
    decl = _q1(PORT)
    gen = prune_columns(decl)
    while gen.inputs:
        gen = gen.inputs[0]
    assert gen.factory_name == "tpch_gen"
    assert sorted(gen.options.columns) == sorted(E.Q1_COLUMNS)
    got = decl.to_table().to_pydict()
    os.environ["ARROW_TPU_NO_PRUNE"] = "1"
    try:
        full = _q1(PORT).to_table().to_pydict()
    finally:
        del os.environ["ARROW_TPU_NO_PRUNE"]
    assert got == full
