"""TPC-H Q1, the pricing summary report (clause 2.4.1), through the plan
engine: lineitem -> filter l_shipdate <= 1998-12-01 - DELTA days -> project
disc_price and charge -> aggregate by (l_returnflag, l_linestatus) the sums
of quantity, price, disc_price and charge, the means of quantity, price and
discount, and count(*) -> order by the keys. ``params["delta"]``: DELTA, in
days (clause 2.4.1.3: [60, 120])."""

import datetime as dtm

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, FilterNodeOptions,
                                   OrderByNodeOptions, ProjectNodeOptions,
                                   TableSourceNodeOptions)
from arrow_tpu_torch.compute.expressions import field, literal

TABLES = {"lineitem": ["l_returnflag", "l_linestatus", "l_quantity",
                       "l_extendedprice", "l_discount", "l_tax",
                       "l_shipdate"]}
KEYS = ["l_returnflag", "l_linestatus"]


def declaration(tables, params):
    cutoff = dtm.date(1998, 12, 1) - dtm.timedelta(days=int(params["delta"]))
    price = field("l_extendedprice")
    disc_price = price * (literal(1.0) - field("l_discount"))
    return Declaration.from_sequence([
        Declaration("table_source",
                    TableSourceNodeOptions(tables["lineitem"])),
        Declaration("filter", FilterNodeOptions(
            field("l_shipdate") <= literal(cutoff))),
        Declaration("project", ProjectNodeOptions(
            [field(k) for k in KEYS] + [
                field("l_quantity"), price, disc_price,
                disc_price * (literal(1.0) + field("l_tax")),
                field("l_discount")],
            KEYS + ["l_quantity", "l_extendedprice", "disc_price", "charge",
                    "l_discount"])),
        Declaration("aggregate", AggregateNodeOptions([
            AggregateSpec("sum", "l_quantity", name="sum_qty"),
            AggregateSpec("sum", "l_extendedprice", name="sum_base_price"),
            AggregateSpec("sum", "disc_price", name="sum_disc_price"),
            AggregateSpec("sum", "charge", name="sum_charge"),
            AggregateSpec("mean", "l_quantity", name="avg_qty"),
            AggregateSpec("mean", "l_extendedprice", name="avg_price"),
            AggregateSpec("mean", "l_discount", name="avg_disc"),
            AggregateSpec("count_all", name="count_order")],
            keys=KEYS, max_groups=16)),
        Declaration("order_by", OrderByNodeOptions(
            [(k, "ascending") for k in KEYS])),
    ])
