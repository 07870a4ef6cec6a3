"""TPC-H Q6, the forecasting revenue change (clause 2.4.6), through the plan
engine: lineitem -> filter l_shipdate in [DATE, DATE + 1 year), l_discount
between DISCOUNT - 0.01 and DISCOUNT + 0.01, l_quantity < QUANTITY ->
project l_extendedprice * l_discount -> the scalar sum as revenue.
``params``: ``date`` (an ISO date, January 1 of 1993-1997), ``discount``
(0.02-0.09), ``quantity`` (24 or 25), clause 2.4.6.3."""

import datetime as dtm

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, FilterNodeOptions,
                                   ProjectNodeOptions, TableSourceNodeOptions)
from arrow_tpu_torch.compute.expressions import field, literal

TABLES = {"lineitem": ["l_shipdate", "l_discount", "l_quantity",
                       "l_extendedprice"]}


def bounds(params):
    """(first day, day after the last, lowest and highest discount,
    quantity bound): the same Python floats the reference compares with."""
    lo = dtm.date.fromisoformat(params["date"])
    d = float(params["discount"])
    return (lo, lo.replace(year=lo.year + 1), round(d - 0.01, 2),
            round(d + 0.01, 2), float(params["quantity"]))


def declaration(tables, params):
    lo, hi, dlo, dhi, qty = bounds(params)
    ship, disc = field("l_shipdate"), field("l_discount")
    return Declaration.from_sequence([
        Declaration("table_source",
                    TableSourceNodeOptions(tables["lineitem"])),
        Declaration("filter", FilterNodeOptions(
            (ship >= literal(lo)) & (ship < literal(hi)) &
            (disc >= literal(dlo)) & (disc <= literal(dhi)) &
            (field("l_quantity") < literal(qty)))),
        Declaration("project", ProjectNodeOptions(
            [field("l_extendedprice") * disc], ["rev"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "rev", name="revenue")])),
    ])
