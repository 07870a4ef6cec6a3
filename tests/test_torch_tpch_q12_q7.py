"""TPC-H Q12 and Q7 on the CPU at SF 0.01: the port's declarations
(``entry.q12_declaration`` / ``q7_declaration``) against pyarrow's run of
the same queries over the same generated tables, and the same plans,
written once over either package's plan engine, through the port's and
the JAX package's ``Declaration.to_table``: counts, keys and order exact,
Q7's float64 revenue within 1e-12 relative. Also the generator's
``columns=``: the columns drawn before a skipped comment keep their
values."""

import numpy as np
import pyarrow as pa
import pytest

from arrow_tpu_torch import entry as E
from arrow_tpu_torch.utils.tpch import tpch_table
from test_torch_acero import JAX, PORT, _drop_jax_executables  # noqa: F401

SF = 0.01
ROWS = 1 << 14


@pytest.fixture(scope="module")
def q12_source():
    return E.entry_q12("cpu", SF)[0].source


@pytest.fixture(scope="module")
def q7_source():
    return E.entry_q7("cpu", SF)[0].source


def _close(got: dict, want: dict, key: str):
    g, w = np.array(got.pop(key)), np.array(want.pop(key))
    assert got == want
    assert np.all(np.abs(g - w) <= 1e-12 * np.abs(w)), (g, w)


def test_q12_against_pyarrow(q12_source):
    step, args = E.entry_q12("cpu", SF, source=q12_source)
    got = step(*args)
    assert got.column_names == ("l_shipmode", "high_line_count",
                                "low_line_count")
    want = E.q12_pyarrow(step.source).to_pydict()
    assert got.to_pydict() == want
    assert want["l_shipmode"] == list(E.Q12_MODES)


def test_q7_against_pyarrow(q7_source):
    step, args = E.entry_q7("cpu", SF, source=q7_source)
    got = step(*args).to_pydict()
    want = E.q7_pyarrow(step.source).to_pydict()
    assert len(want["revenue"]) == 4
    _close(got, want, "revenue")


def _q12(P, li, od):
    """Q12 over either package's plan engine (``entry.q12_declaration``'s
    plan)."""
    import datetime as dtm
    A, f, lit = P.acero, P.field, P.literal
    from arrow_tpu_torch.core import datatype as tdt
    from arrow_tpu.core import datatype as jdt
    i64 = tdt.int64 if P is PORT else jdt.int64
    keep = f("l_shipmode").isin(list(E.Q12_MODES)) & \
        (f("l_commitdate") < f("l_receiptdate")) & \
        (f("l_shipdate") < f("l_commitdate")) & \
        (f("l_receiptdate") >= lit(dtm.date(1994, 1, 1))) & \
        (f("l_receiptdate") < lit(dtm.date(1995, 1, 1)))
    urgent = f("o_orderpriority").isin(list(E.Q12_PRIORITIES))
    src = [A.Declaration("table_source", A.TableSourceNodeOptions(t))
           for t in (li, od)]
    return A.Declaration.from_sequence([
        A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_shipmode"], right_output=["o_orderpriority"],
            max_build_rows=od.num_rows), inputs=[
                A.Declaration.from_sequence([src[0], A.Declaration(
                    "filter", A.FilterNodeOptions(keep))]), src[1]]),
        A.Declaration("project", A.ProjectNodeOptions(
            [f("l_shipmode"), urgent.cast(i64), (~urgent).cast(i64)],
            ["l_shipmode", "high", "low"])),
        A.Declaration("aggregate", A.AggregateNodeOptions(
            [A.AggregateSpec("sum", "high", name="high_line_count"),
             A.AggregateSpec("sum", "low", name="low_line_count")],
            keys=["l_shipmode"], max_groups=16)),
        A.Declaration("order_by", A.OrderByNodeOptions(
            [("l_shipmode", "ascending")])),
    ])


def test_q12_in_both_plan_engines(q12_source):
    li, od = q12_source["lineitem"], q12_source["orders"]
    got = _q12(PORT, PORT.table(li, ROWS), PORT.table(od, ROWS)).to_table()
    want = _q12(JAX, JAX.table(li, ROWS), JAX.table(od, ROWS)).to_table()
    assert got.to_pydict() == want.to_pydict() == \
        E.q12_pyarrow(q12_source).to_pydict()


def _q7(P, su, li, od, cu, na):
    """Q7 over either package's plan engine (``entry.q7_declaration``'s
    plan)."""
    import datetime as dtm
    A, f, lit = P.acero, P.field, P.literal
    from arrow_tpu_torch.compute.expressions import call as tcall
    from arrow_tpu.compute.expressions import call as jcall
    call = tcall if P is PORT else jcall

    def src(t):
        return A.Declaration("table_source", A.TableSourceNodeOptions(t))

    def nation_side(key, name):
        return A.Declaration.from_sequence([
            src(na), A.Declaration("filter", A.FilterNodeOptions(
                f("n_name").isin(list(E.Q7_NATIONS)))),
            A.Declaration("project", A.ProjectNodeOptions(
                [f("n_nationkey"), f("n_name")], [key, name]))])

    def join(left, right, lk, rk, lout, rout, rows):
        return A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=[lk], right_keys=[rk], left_output=lout,
            right_output=rout, max_build_rows=max(rows, 16)),
            inputs=[left, right])

    supp = join(src(su), nation_side("s_nk", "supp_nation"), "s_nationkey",
                "s_nk", ["s_suppkey"], ["supp_nation"], 25)
    cust = join(src(cu), nation_side("c_nk", "cust_nation"), "c_nationkey",
                "c_nk", ["c_custkey"], ["cust_nation"], 25)
    ords = join(src(od), cust, "o_custkey", "c_custkey", ["o_orderkey"],
                ["cust_nation"], cu.num_rows)
    shipped = A.Declaration.from_sequence([src(li), A.Declaration(
        "filter", A.FilterNodeOptions(
            (f("l_shipdate") >= lit(dtm.date(1995, 1, 1))) &
            (f("l_shipdate") <= lit(dtm.date(1996, 12, 31)))))])
    lj = join(shipped, supp, "l_suppkey", "s_suppkey",
              ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"],
              ["supp_nation"], su.num_rows)
    full = join(lj, ords, "l_orderkey", "o_orderkey",
                ["supp_nation", "l_shipdate", "l_extendedprice",
                 "l_discount"], ["cust_nation"], od.num_rows)
    a, b = E.Q7_NATIONS
    pair = ((f("supp_nation") == lit(a)) & (f("cust_nation") == lit(b))) | \
        ((f("supp_nation") == lit(b)) & (f("cust_nation") == lit(a)))
    return A.Declaration.from_sequence([
        full, A.Declaration("filter", A.FilterNodeOptions(pair)),
        A.Declaration("project", A.ProjectNodeOptions(
            [f("supp_nation"), f("cust_nation"),
             call("year", [f("l_shipdate")]),
             f("l_extendedprice") * (lit(1.0) - f("l_discount"))],
            ["supp_nation", "cust_nation", "l_year", "volume"])),
        A.Declaration("aggregate", A.AggregateNodeOptions(
            [A.AggregateSpec("sum", "volume", name="revenue")],
            keys=["supp_nation", "cust_nation", "l_year"], max_groups=64)),
        A.Declaration("order_by", A.OrderByNodeOptions(
            [("supp_nation", "ascending"), ("cust_nation", "ascending"),
             ("l_year", "ascending")])),
    ])


def test_q7_in_both_plan_engines(q7_source):
    names = ("supplier", "lineitem", "orders", "customer", "nation")
    got = _q7(PORT, *[PORT.table(q7_source[n], ROWS) for n in names]
              ).to_table().to_pydict()
    want = _q7(JAX, *[JAX.table(q7_source[n], ROWS) for n in names]
               ).to_table().to_pydict()
    oracle = E.q7_pyarrow(q7_source).to_pydict()
    _close(dict(got), dict(want), "revenue")
    _close(got, oracle, "revenue")


@pytest.mark.parametrize("name,comment", [("lineitem", "l_comment"),
                                          ("orders", "o_comment"),
                                          ("customer", "c_comment")])
def test_generator_columns_skip_only_the_comment(name, comment):
    full = tpch_table(name, SF, 42)
    cols = [c for c in full.column_names if c != comment]
    part = tpch_table(name, SF, 42, columns=cols)
    assert part.column_names == cols
    assert part.equals(full.select(cols))
    some = tpch_table(name, SF, 42, columns=[cols[1], comment])
    assert some.equals(full.select([cols[1], comment]))


def test_q22_code_set_is_one_is_in():
    """Path 11's code set is one ``is_in`` (TPC-H's ``IN (...)``), not an
    or of string equals."""
    cu = PORT.table(pa.table({"c_custkey": [1], "c_phone": ["13-1"],
                              "c_acctbal": [1.0]}))
    text = repr(E._q22_customers(cu, 0.0).options.filter_expression)
    assert "is_in(cntrycode)" in text and "or_kleene" not in text
