"""db-benchmark groupby q3: sum v1, mean v3 by id3 (N/K = 1e6 groups),
through the plan engine: table_source -> aggregate. ``max_groups`` covers
the groups, so the aggregate never replays its stream."""

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, TableSourceNodeOptions)

TABLES = {"x": ["id3", "v1", "v3"]}


def declaration(tables, params):
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(tables["x"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "v1", name="v1"),
             AggregateSpec("mean", "v3", name="v3")],
            keys=["id3"], max_groups=1 << 20)),
    ])
