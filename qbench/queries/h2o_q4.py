"""db-benchmark groupby q4: mean v1:v3 by id4 (K = 100 groups), through the
plan engine: table_source -> aggregate. ``max_groups`` covers the groups,
so the aggregate never replays its stream."""

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, TableSourceNodeOptions)

TABLES = {"x": ["id4", "v1", "v2", "v3"]}


def declaration(tables, params):
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(tables["x"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("mean", "v1", name="v1"),
             AggregateSpec("mean", "v2", name="v2"),
             AggregateSpec("mean", "v3", name="v3")],
            keys=["id4"], max_groups=1 << 16)),
    ])
