"""TPC-H Q3 in plain torch: every order of a SEGMENT customer placed
before DATE, with its revenue over its lines shipped after DATE. The check
takes the first 10 by (revenue desc, o_orderdate, l_orderkey)."""

import datetime as dtm

import torch

from qbench.data import code_of
from qbench.plain import floats, group_sum, host

KEYS = ["l_orderkey"]
ORDER = [("revenue", "descending"), ("o_orderdate", "ascending"),
         ("l_orderkey", "ascending")]
LIMIT = 10


def answer(tables, params, dtype):
    cu, od, li = tables["customer"], tables["orders"], tables["lineitem"]
    date = (dtm.date.fromisoformat(params["date"]) -
            dtm.date(1970, 1, 1)).days
    seg = code_of(cu["c_mktsegment"], params["segment"])
    custkey = cu["c_custkey"].values
    in_segment = torch.zeros(int(custkey.max()) + 1, dtype=torch.bool,
                             device=custkey.device)
    in_segment[custkey[cu["c_mktsegment"].values == seg]] = True
    okey = od["o_orderkey"].values
    order_ok = (od["o_orderdate"].values < date) & \
        in_segment[od["o_custkey"].values]
    # orderkey -> order row, by a dense table over the sparse keys
    row_of = torch.full((int(okey.max()) + 1,), -1, dtype=torch.int64,
                        device=okey.device)
    row_of[okey] = torch.arange(okey.numel(), device=okey.device)
    oi = row_of[li["l_orderkey"].values]
    line_ok = (li["l_shipdate"].values > date) & order_ok[oi]
    oi = oi[line_ok]
    rev = li["l_extendedprice"].values[line_ok].to(dtype) * \
        (1.0 - li["l_discount"].values[line_ok].to(dtype))
    n = okey.numel()
    revenue = group_sum(oi, rev, n, dtype)
    has = torch.zeros(n, dtype=torch.bool, device=okey.device)
    has[oi] = True
    return {"l_orderkey": host(okey[has]),
            "o_orderdate": host(od["o_orderdate"].values[has]),
            "o_shippriority": host(od["o_shippriority"].values[has]),
            "revenue": floats(revenue[has])}
