"""TPC-H Q6 in plain torch: sum(l_extendedprice * l_discount) over the
lines shipped in the year from DATE with a discount within 0.01 of DISCOUNT
and a quantity under QUANTITY."""

import datetime as dtm

import numpy as np

from qbench.plain import floats

KEYS = []
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    li = tables["lineitem"]
    lo = dtm.date.fromisoformat(params["date"])
    epoch = dtm.date(1970, 1, 1)
    d = float(params["discount"])
    ship, disc = li["l_shipdate"].values, li["l_discount"].values
    keep = ((ship >= (lo - epoch).days) &
            (ship < (lo.replace(year=lo.year + 1) - epoch).days) &
            (disc >= round(d - 0.01, 2)) & (disc <= round(d + 0.01, 2)) &
            (li["l_quantity"].values < float(params["quantity"])))
    rev = li["l_extendedprice"].values[keep].to(dtype) * disc[keep].to(dtype)
    return {"revenue": np.atleast_1d(floats(rev.sum()))}
