"""TPC-H Q1 in plain torch: the lines shipped by 1998-12-01 - DELTA days,
by (l_returnflag, l_linestatus), ordered by the flags' strings."""

import datetime as dtm

import numpy as np

from qbench.plain import (dict_size, dict_strings, floats, group_sum, host,
                          present)

KEYS = ["l_returnflag", "l_linestatus"]
ORDER = [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]
LIMIT = None


def answer(tables, params, dtype):
    li = tables["lineitem"]
    cutoff = (dtm.date(1998, 12, 1) - dtm.timedelta(days=int(params["delta"]))
              - dtm.date(1970, 1, 1)).days
    keep = li["l_shipdate"].values <= cutoff
    m_ls = dict_size(li["l_linestatus"])
    m = dict_size(li["l_returnflag"]) * m_ls
    g = (li["l_returnflag"].values.long() * m_ls +
         li["l_linestatus"].values.long())[keep]
    qty, price, disc, tax = (li[c].values[keep].to(dtype) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (1.0 - disc)
    groups, count = present(g, m)
    sums = {name: group_sum(g, v, m, dtype)[groups] for name, v in (
        ("sum_qty", qty), ("sum_base_price", price),
        ("sum_disc_price", disc_price),
        ("sum_charge", disc_price * (1.0 + tax)), ("avg_qty", qty),
        ("avg_price", price), ("avg_disc", disc))}
    n = count[groups].to(dtype)
    out = {"l_returnflag": dict_strings(li["l_returnflag"], groups // m_ls),
           "l_linestatus": dict_strings(li["l_linestatus"], groups % m_ls)}
    for name, s in sums.items():
        out[name] = floats(s / n if name.startswith("avg") else s)
    out["count_order"] = host(count[groups])
    order = np.lexsort((out["l_linestatus"], out["l_returnflag"]))
    return {k: v[order] for k, v in out.items()}
