"""TPC-H Q3, the shipping priority query (clause 2.4.3), through the plan
engine: customer filtered by c_mktsegment = SEGMENT, orders by o_orderdate <
DATE, lineitem by l_shipdate > DATE; orders join customer on o_custkey,
lineitem joins that on l_orderkey; revenue = sum(l_extendedprice * (1 -
l_discount)) by (l_orderkey, o_orderdate, o_shippriority); order by revenue
desc, o_orderdate (then l_orderkey, to make ties deterministic); the first
10. ``params``: ``segment`` (one of the 5), ``date`` (an ISO date in
1995-03-01..31), clause 2.4.3.3. The joins' build capacities are the build
tables' rows; ``max_groups`` covers the orders that can qualify."""

import datetime as dtm

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, FetchNodeOptions,
                                   FilterNodeOptions, HashJoinNodeOptions,
                                   OrderByNodeOptions, ProjectNodeOptions,
                                   TableSourceNodeOptions)
from arrow_tpu_torch.compute.expressions import field, literal

TABLES = {"customer": ["c_custkey", "c_mktsegment"],
          "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                     "o_shippriority"],
          "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                       "l_shipdate"]}
KEYS = ["l_orderkey", "o_orderdate", "o_shippriority"]


def _source(table, predicate):
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(table)),
        Declaration("filter", FilterNodeOptions(predicate))])


def declaration(tables, params):
    date = literal(dtm.date.fromisoformat(params["date"]))
    customer, orders = tables["customer"], tables["orders"]
    cust_orders = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        left_output=["o_orderkey", "o_orderdate", "o_shippriority"],
        right_output=[], max_build_rows=customer.num_rows),
        inputs=[_source(orders, field("o_orderdate") < date),
                _source(customer,
                        field("c_mktsegment") == params["segment"])])
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_orderkey", "l_extendedprice", "l_discount"],
            right_output=["o_orderdate", "o_shippriority"],
            max_build_rows=orders.num_rows),
            inputs=[_source(tables["lineitem"], field("l_shipdate") > date),
                    cust_orders]),
        Declaration("project", ProjectNodeOptions(
            [field(k) for k in KEYS] + [
                field("l_extendedprice") * (literal(1.0) -
                                            field("l_discount"))],
            KEYS + ["rev"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "rev", name="revenue")], keys=KEYS,
            max_groups=1 << 20)),
        Declaration("order_by", OrderByNodeOptions(
            [("revenue", "descending"), ("o_orderdate", "ascending"),
             ("l_orderkey", "ascending")])),
        Declaration("fetch", FetchNodeOptions(0, 10)),
    ])
