"""The generators' domains and key structure against their sources, on the
CPU at a small size."""

import numpy as np
import pytest
import torch

from qbench.data import strings
from qbench.gen import h2o_groupby, tpch

CPU = torch.device("cpu")
LINEITEM = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
            "l_quantity", "l_extendedprice", "l_discount", "l_tax",
            "l_shipdate", "l_commitdate", "l_receiptdate", "l_returnflag",
            "l_linestatus", "l_shipinstruct", "l_shipmode"]
ORDERS = ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
          "o_totalprice", "o_orderstatus", "o_orderpriority"]
CUSTOMER = ["c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment"]


def _tpch(seed=7, sf=0.005):
    t = tpch.generate({"scale_factor": sf}, seed, CPU,
                      {"lineitem": LINEITEM, "orders": ORDERS,
                       "customer": CUSTOMER})
    return {name: {c: col.values.numpy() for c, col in cols.items()}
            for name, cols in t.items()}, t


def test_tpch_keys_and_lines():
    t, _ = _tpch()
    o, li = t["orders"], t["lineitem"]
    assert len(o["o_orderkey"]) == 7500
    # sparse orderkeys: 8 of each 32 keys, from 1
    assert set(np.unique((o["o_orderkey"] - 1) % 32)) == set(range(8))
    assert np.all(np.diff(o["o_orderkey"]) > 0)
    lines = np.bincount(np.searchsorted(o["o_orderkey"], li["l_orderkey"]))
    assert lines.min() >= 1 and lines.max() <= 7
    assert set(np.unique(lines)) == set(range(1, 8))
    assert np.all(np.isin(li["l_orderkey"], o["o_orderkey"]))
    # customers = 0 (mod 3) place no orders
    assert not np.any(o["o_custkey"] % 3 == 0)
    assert o["o_custkey"].min() >= 1 and o["o_custkey"].max() <= 750
    first = np.concatenate([[0], np.cumsum(lines)[:-1]])
    assert np.array_equal(li["l_linenumber"][first], np.ones(len(first)))


def test_tpch_dates_prices_flags():
    t, raw = _tpch()
    o, li = t["orders"], t["lineitem"]
    day = tpch.day
    assert o["o_orderdate"].min() >= day(1992, 1, 1)
    assert o["o_orderdate"].max() <= day(1998, 12, 31) - 151
    odate = o["o_orderdate"][np.searchsorted(o["o_orderkey"],
                                             li["l_orderkey"])]
    ship = li["l_shipdate"] - odate
    assert ship.min() == 1 and ship.max() == 121
    commit = li["l_commitdate"] - odate
    assert commit.min() == 30 and commit.max() == 90
    receipt = li["l_receiptdate"] - li["l_shipdate"]
    assert receipt.min() == 1 and receipt.max() == 30
    pk = li["l_partkey"]
    retail = (90000 + (pk // 10) % 20001 + 100 * (pk % 1000)) / 100.0
    assert np.array_equal(li["l_extendedprice"],
                          np.round(li["l_quantity"] * retail, 2))
    assert set(np.unique(li["l_quantity"])) == set(range(1, 51))
    assert set(np.unique(np.rint(li["l_discount"] * 100))) == set(range(11))
    assert set(np.unique(np.rint(li["l_tax"] * 100))) == set(range(9))
    flag = strings(raw["lineitem"]["l_returnflag"].offsets,
                   raw["lineitem"]["l_returnflag"].pool,
                   raw["lineitem"]["l_returnflag"].values)
    received = li["l_receiptdate"] <= tpch.CURRENT
    assert set(flag[received]) == {b"R", b"A"}
    assert set(flag[~received]) == {b"N"}
    status = strings(raw["lineitem"]["l_linestatus"].offsets,
                     raw["lineitem"]["l_linestatus"].pool,
                     raw["lineitem"]["l_linestatus"].values)
    assert np.array_equal(status == b"O", li["l_shipdate"] > tpch.CURRENT)
    seg = raw["customer"]["c_mktsegment"]
    assert set(strings(seg.offsets, seg.pool, seg.values)) == \
        {s.encode() for s in tpch.SEGMENTS}
    # o_totalprice: the order's lines, as the specification derives it
    per_line = li["l_extendedprice"] * (1 + li["l_tax"]) * \
        (1 - li["l_discount"])
    idx = np.searchsorted(o["o_orderkey"], li["l_orderkey"])
    total = np.zeros(len(o["o_orderkey"]))
    np.add.at(total, idx, per_line)
    assert np.allclose(o["o_totalprice"], np.round(total, 2), atol=0.011)


def test_tpch_seeded_and_columns_independent():
    a, _ = _tpch(seed=3)
    b, _ = _tpch(seed=3)
    c, _ = _tpch(seed=4)
    for name in a["lineitem"]:
        assert np.array_equal(a["lineitem"][name], b["lineitem"][name])
    assert not np.array_equal(a["lineitem"]["l_partkey"],
                              c["lineitem"]["l_partkey"])
    alone = tpch.generate({"scale_factor": 0.005}, 3, CPU,
                          {"lineitem": ["l_discount"]})
    assert np.array_equal(alone["lineitem"]["l_discount"].values.numpy(),
                          a["lineitem"]["l_discount"])


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, -9])
def test_h2o_domains(seed):
    n, k = 50000, 10
    cols = ["id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3"]
    x = h2o_groupby.generate({"rows": n, "k": k}, seed, CPU,
                             {"x": cols})["x"]
    v = {c: x[c].values.numpy() for c in cols}
    assert all(len(a) == n for a in v.values())
    assert v["id1"].min() == 0 and v["id1"].max() == k - 1
    assert v["id3"].min() == 0 and v["id3"].max() == n // k - 1
    assert strings(x["id1"].offsets, x["id1"].pool)[[0, -1]].tolist() == \
        [b"id001", b"id010"]
    assert strings(x["id3"].offsets, x["id3"].pool)[[0, -1]].tolist() == \
        [b"id0000000001", b"id0000005000"]
    for c, lo, hi in (("id4", 1, k), ("id5", 1, k), ("id6", 1, n // k),
                      ("v1", 1, 5), ("v2", 1, 15)):
        assert v[c].dtype == np.int32
        assert v[c].min() == lo and v[c].max() == hi, c
    assert v["v3"].dtype == np.float64
    assert v["v3"].min() >= 0 and v["v3"].max() < 100
    assert np.array_equal(v["v3"], np.round(v["v3"], 6))
    assert len(np.unique(v["v3"])) > n * 0.99


def test_h2o_whole_table_held():
    """The card holds all nine columns, 40 bytes a row, whichever the
    queries read; a cell's Tables hold only the columns read, as views."""
    n = 20000
    x = h2o_groupby.generate({"rows": n, "k": 10}, 4, CPU,
                             {"x": ["id1", "v1"]})["x"]
    assert list(x) == list(h2o_groupby.COLUMNS)
    assert sum(c.values.element_size() for c in x.values()) == 40
    with pytest.raises(KeyError):
        h2o_groupby.generate({"rows": n, "k": 10}, 4, CPU, {"x": ["v9"]})


def test_digest_sees_a_write():
    from qbench.data import digest
    raw = tpch.generate({"scale_factor": 0.002}, 1, CPU,
                        {"orders": ["o_orderkey", "o_orderdate"]})
    before = digest(raw)
    assert digest(raw) == before
    v = raw["orders"]["o_orderdate"].values
    v[[0, 1]] = v[[1, 0]].clone()
    assert v[0] != v[1] and digest(raw) != before
