"""TPC-H tables on the device, with the specification's structure.

A torch rewrite of the distributions the port's ``utils/tpch.py`` draws
(TPC-H 3.0.1 clause 4.2.3) for the columns the benchmark's queries read, and
their neighbours: sparse orderkeys (8 keys used of each 32), 1-7 lines an
order, custkeys = 0 (mod 3) placing no orders, order dates uniform in
[1992-01-01, 1998-12-31 - 151 days], ship = order + [1, 121] days, commit =
order + [30, 90], receipt = ship + [1, 30], l_extendedprice = l_quantity x
p_retailprice(l_partkey), discount [0, 0.10] and tax [0, 0.08] in cents,
linestatus O past 1995-06-17, returnflag R / A for a line received by then
and N otherwise, o_totalprice and o_orderstatus from the order's lines. Keys
are int64, money float64 (as ``utils/tpch.py`` makes DECIMAL(15,2)), dates
date32, flags and segments dictionary<int32, utf8>. Each column draws from a
stream of its own, so a column's values do not depend on which others a cell
stages.
"""

from __future__ import annotations

import datetime as dtm

import torch

from qbench.data import Column, stream, words

_EPOCH = dtm.date(1970, 1, 1)


def day(y: int, m: int, d: int) -> int:
    return (dtm.date(y, m, d) - _EPOCH).days


START, CURRENT, END = day(1992, 1, 1), day(1995, 6, 17), day(1998, 12, 31)

SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
INSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
RETURNFLAGS = ["R", "A", "N"]
LINESTATUS = ["F", "O"]
ORDERSTATUS = ["F", "O", "P"]


def generate(config: dict, seed: int, device, columns: dict) -> dict:
    """``{table: {column: Column}}`` with the ``columns`` asked for of
    customer, orders and lineitem at ``config["scale_factor"]``."""
    sf = float(config["scale_factor"])
    n_orders = max(int(1_500_000 * sf), 10)
    n_cust = max(int(150_000 * sf), 5)
    n_part = max(int(200_000 * sf), 5)
    n_supp = max(int(10_000 * sf), 3)
    memo = {}

    def randint(table, name, lo, hi, n, dtype=torch.int64):
        """n draws uniform in [lo, hi] from the stream table.name."""
        return torch.randint(lo, hi + 1, (n,), dtype=dtype, device=device,
                             generator=stream(seed, table, name,
                                              device=device))

    def dict_col(table, name, vocab, n):
        return Column("dict", randint(table, name, 0, len(vocab) - 1, n,
                                      torch.int32), *words(vocab, device))

    def get(key):
        if key not in memo:
            memo[key] = make(key)
        return memo[key]

    def make(key):
        # the orders' skeleton, which lineitem repeats line by line
        if key == "o_idx":
            return torch.arange(n_orders, dtype=torch.int64, device=device)
        if key == "o_orderkey":
            i = get("o_idx")
            return (i // 8) * 32 + i % 8 + 1
        if key == "o_custkey":
            c = randint("orders", "custkey", 1, n_cust, n_orders)
            bump = torch.where(c + 1 > n_cust, c - 1, c + 1)
            return torch.where(c % 3 == 0, bump, c)
        if key == "o_orderdate":
            return randint("orders", "orderdate", START, END - 151,
                           n_orders, torch.int32)
        if key == "o_lines":
            return randint("orders", "lines", 1, 7, n_orders)
        if key == "l_count":
            return int(get("o_lines").sum())
        if key in ("l_orderkey", "l_orderdate", "l_order"):
            src = {"l_orderkey": get("o_orderkey"),
                   "l_orderdate": get("o_orderdate"),
                   "l_order": get("o_idx")}[key]
            return torch.repeat_interleave(src, get("o_lines"),
                                           output_size=get("l_count"))
        n = get("l_count")
        if key == "l_linenumber":
            first = torch.cumsum(get("o_lines"), 0) - get("o_lines")
            return torch.arange(n, dtype=torch.int64, device=device) - \
                torch.repeat_interleave(first, get("o_lines"),
                                        output_size=n) + 1
        if key == "l_partkey":
            return randint("lineitem", "partkey", 1, n_part, n)
        if key == "l_suppkey":
            pk = get("l_partkey")
            i = randint("lineitem", "supplier_slot", 0, 3, n)
            return (pk + i * (n_supp // 4 + (pk - 1) // n_supp)) % n_supp + 1
        if key == "l_quantity":
            return randint("lineitem", "quantity", 1, 50, n).to(torch.float64)
        if key == "l_extendedprice":
            pk = get("l_partkey")
            retail = (90000 + (pk // 10) % 20001 +
                      100 * (pk % 1000)).to(torch.float64) / 100.0
            return torch.round(get("l_quantity") * retail, decimals=2)
        if key == "l_discount":
            return randint("lineitem", "discount", 0, 10, n).to(
                torch.float64) / 100.0
        if key == "l_tax":
            return randint("lineitem", "tax", 0, 8, n).to(
                torch.float64) / 100.0
        if key == "l_shipdate":
            return get("l_orderdate") + randint("lineitem", "ship", 1, 121, n,
                                                torch.int32)
        if key == "l_commitdate":
            return get("l_orderdate") + randint("lineitem", "commit", 30, 90,
                                                n, torch.int32)
        if key == "l_receiptdate":
            return get("l_shipdate") + randint("lineitem", "receipt", 1, 30,
                                               n, torch.int32)
        if key == "l_returnflag":
            ra = randint("lineitem", "returnflag", 0, 1, n, torch.int32)
            flag = torch.where(get("l_receiptdate") <= CURRENT, ra,
                               torch.full_like(ra, 2))
            return Column("dict", flag, *words(RETURNFLAGS, device))
        if key == "l_linestatus":
            return Column("dict", (get("l_shipdate") > CURRENT).to(
                torch.int32), *words(LINESTATUS, device))
        if key == "l_shipinstruct":
            return dict_col("lineitem", "shipinstruct", INSTRUCT, n)
        if key == "l_shipmode":
            return dict_col("lineitem", "shipmode", MODES, n)
        if key == "o_totalprice":
            per_line = get("l_extendedprice") * (1.0 + get("l_tax")) * \
                (1.0 - get("l_discount"))
            # a (orders, 7) matrix of the lines summed along its rows: the
            # same order of additions on every run, unlike index_add_
            mat = torch.zeros((n_orders, 7), dtype=torch.float64,
                              device=device)
            mat[get("l_order"), get("l_linenumber") - 1] = per_line
            return torch.round(mat.sum(1), decimals=2)
        if key == "o_orderstatus":
            open_ = torch.zeros(n_orders, dtype=torch.int64, device=device)
            open_.index_add_(0, get("l_order"),
                             (get("l_shipdate") > CURRENT).to(torch.int64))
            status = torch.where(open_ == 0, 0, torch.where(
                open_ == get("o_lines"), 1, 2)).to(torch.int32)
            return Column("dict", status, *words(ORDERSTATUS, device))
        if key == "o_orderpriority":
            return dict_col("orders", "orderpriority", PRIORITIES, n_orders)
        if key == "o_shippriority":
            return torch.zeros(n_orders, dtype=torch.int64, device=device)
        if key == "c_custkey":
            return torch.arange(1, n_cust + 1, dtype=torch.int64,
                                device=device)
        if key == "c_nationkey":
            return randint("customer", "nationkey", 0, 24, n_cust)
        if key == "c_acctbal":
            u = torch.rand((n_cust,), dtype=torch.float64, device=device,
                           generator=stream(seed, "customer", "acctbal",
                                            device=device))
            return torch.round(-999.99 + u * (9999.99 + 999.99), decimals=2)
        if key == "c_mktsegment":
            return dict_col("customer", "mktsegment", SEGMENTS, n_cust)
        raise KeyError(f"the TPC-H generator makes no column {key!r}")

    def column(name) -> Column:
        v = get(name)
        if isinstance(v, Column):
            return v
        kind = {torch.int64: "int64", torch.float64: "float64"}.get(v.dtype)
        if name.endswith("date"):
            kind = "date32"
        return Column(kind, v)

    tables = {}
    for table, names in columns.items():
        if table not in ("customer", "orders", "lineitem"):
            raise KeyError(f"the TPC-H generator makes no table {table!r}")
        tables[table] = {c: column(c) for c in names}
    return tables
