"""db-benchmark groupby q5: sum v1:v3 by id6 (N/K = 1e6 groups), through the
plan engine: table_source -> aggregate. ``max_groups`` covers the groups,
so the aggregate never replays its stream."""

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, TableSourceNodeOptions)

TABLES = {"x": ["id6", "v1", "v2", "v3"]}


def declaration(tables, params):
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(tables["x"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "v1", name="v1"),
             AggregateSpec("sum", "v2", name="v2"),
             AggregateSpec("sum", "v3", name="v3")],
            keys=["id6"], max_groups=1 << 20)),
    ])
