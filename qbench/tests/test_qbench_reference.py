"""Each plain reference against pyarrow's answer on the same data, on the
CPU at a small size."""

import datetime as dtm

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from qbench import catalog, check
from qbench.data import strings
from qbench.gen import h2o_groupby, tpch

CPU = torch.device("cpu")
EPOCH = dtm.date(1970, 1, 1)


def arrow(raw: dict) -> pa.Table:
    cols = {}
    for name, col in raw.items():
        if col.kind == "dict":
            cols[name] = pa.array(strings(col.offsets, col.pool, col.values))
        else:
            cols[name] = pa.array(col.values.numpy())
    return pa.table(cols)


def numpy_of(t: pa.Table) -> dict:
    return {c: np.asarray(t[c].to_numpy(zero_copy_only=False))
            for c in t.column_names}


def held(query, params, raw, got):
    ref = catalog.module("reference", query)
    want = ref.answer(raw, params, torch.float64)
    return check.compare(got, want, ref.KEYS, None, None, 1e-12)


H2O = {"h2o_q1": (["id1"], [("v1", "sum")]),
       "h2o_q2": (["id1", "id2"], [("v1", "sum")]),
       "h2o_q3": (["id3"], [("v1", "sum"), ("v3", "mean")]),
       "h2o_q4": (["id4"], [("v1", "mean"), ("v2", "mean"), ("v3", "mean")]),
       "h2o_q5": (["id6"], [("v1", "sum"), ("v2", "sum"), ("v3", "sum")])}


@pytest.mark.parametrize("query", sorted(H2O))
def test_h2o_reference_vs_pyarrow(query):
    keys, aggs = H2O[query]
    cols = keys + [c for c, _ in aggs]
    raw = h2o_groupby.generate({"rows": 30000, "k": 10}, 1, CPU,
                               {"x": cols})
    t = arrow(raw["x"]).group_by(keys).aggregate(aggs)
    t = t.rename_columns([c.rsplit("_", 1)[0] if c not in keys else c
                          for c in t.column_names])
    got = numpy_of(t)
    for k in keys:
        if got[k].dtype == object:
            got[k] = got[k].astype("S")
    for c, f in aggs:
        if f == "sum" and c != "v3":
            got[c] = got[c].astype(np.int64)
    assert held(query, {}, raw, got) == (0, pytest.approx(0.0, abs=1e-13))


def _tpch(columns):
    return tpch.generate({"scale_factor": 0.01}, 2, CPU, columns)


@pytest.mark.parametrize("delta", [60, 90, 120])
def test_tpch_q1_reference_vs_pyarrow(delta):
    q = catalog.module("queries", "tpch_q1")
    raw = _tpch(q.TABLES)
    li = arrow(raw["lineitem"])
    cut = (dtm.date(1998, 12, 1) - dtm.timedelta(days=delta) - EPOCH).days
    li = li.filter(pc.less_equal(li["l_shipdate"], cut))
    dp = pc.multiply(li["l_extendedprice"],
                     pc.subtract(1.0, li["l_discount"]))
    li = li.append_column("dp", dp).append_column(
        "ch", pc.multiply(dp, pc.add(1.0, li["l_tax"])))
    t = li.group_by(["l_returnflag", "l_linestatus"]).aggregate([
        ("l_quantity", "sum"), ("l_extendedprice", "sum"), ("dp", "sum"),
        ("ch", "sum"), ("l_quantity", "mean"), ("l_extendedprice", "mean"),
        ("l_discount", "mean"), ("l_quantity", "count")])
    names = {"l_quantity_sum": "sum_qty",
             "l_extendedprice_sum": "sum_base_price",
             "dp_sum": "sum_disc_price", "ch_sum": "sum_charge",
             "l_quantity_mean": "avg_qty",
             "l_extendedprice_mean": "avg_price",
             "l_discount_mean": "avg_disc", "l_quantity_count": "count_order"}
    got = {names.get(k, k): v for k, v in numpy_of(t).items()}
    for k in ("l_returnflag", "l_linestatus"):
        got[k] = got[k].astype("S")
    assert held("tpch_q1", {"delta": delta}, raw, got) == \
        (0, pytest.approx(0.0, abs=1e-13))


@pytest.mark.parametrize("params", [
    {"date": "1994-01-01", "discount": 0.06, "quantity": 24},
    {"date": "1997-01-01", "discount": 0.02, "quantity": 25}])
def test_tpch_q6_reference_vs_pyarrow(params):
    q = catalog.module("queries", "tpch_q6")
    raw = _tpch(q.TABLES)
    li = arrow(raw["lineitem"])
    lo = dtm.date.fromisoformat(params["date"])
    d = params["discount"]
    keep = pc.and_(pc.and_(
        pc.greater_equal(li["l_shipdate"], (lo - EPOCH).days),
        pc.less(li["l_shipdate"],
                (lo.replace(year=lo.year + 1) - EPOCH).days)),
        pc.and_(pc.and_(pc.greater_equal(li["l_discount"], round(d - .01, 2)),
                        pc.less_equal(li["l_discount"], round(d + .01, 2))),
                pc.less(li["l_quantity"], float(params["quantity"]))))
    li = li.filter(keep)
    rev = pc.sum(pc.multiply(li["l_extendedprice"], li["l_discount"]))
    got = {"revenue": np.array([rev.as_py()])}
    assert held("tpch_q6", params, raw, got) == \
        (0, pytest.approx(0.0, abs=1e-13))


@pytest.mark.parametrize("params", [
    {"segment": "BUILDING", "date": "1995-03-15"},
    {"segment": "HOUSEHOLD", "date": "1995-03-01"}])
def test_tpch_q3_reference_vs_pyarrow(params):
    q = catalog.module("queries", "tpch_q3")
    raw = _tpch(q.TABLES)
    cu, od, li = (arrow(raw[t]) for t in ("customer", "orders", "lineitem"))
    date = (dtm.date.fromisoformat(params["date"]) - EPOCH).days
    cu = cu.filter(pc.equal(cu["c_mktsegment"], params["segment"]))
    od = od.filter(pc.less(od["o_orderdate"], date))
    li = li.filter(pc.greater(li["l_shipdate"], date))
    co = od.join(cu, "o_custkey", "c_custkey", join_type="inner")
    j = li.join(co, "l_orderkey", "o_orderkey", join_type="inner")
    j = j.append_column("rev", pc.multiply(
        j["l_extendedprice"], pc.subtract(1.0, j["l_discount"])))
    t = j.group_by(["l_orderkey", "o_orderdate", "o_shippriority"]) \
        .aggregate([("rev", "sum")])
    got = {("revenue" if k == "rev_sum" else k): v
           for k, v in numpy_of(t).items()}
    assert len(got["l_orderkey"]) > 10
    assert held("tpch_q3", params, raw, got) == \
        (0, pytest.approx(0.0, abs=1e-13))
