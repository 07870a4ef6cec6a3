"""db-benchmark groupby q2: sum v1 by id1, id2 (K^2 = 10,000 groups), through
the plan engine: table_source -> aggregate. ``max_groups`` covers the
groups, so the aggregate never replays its stream."""

from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                   Declaration, TableSourceNodeOptions)

TABLES = {"x": ["id1", "id2", "v1"]}


def declaration(tables, params):
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(tables["x"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "v1", name="v1")],
            keys=["id1", "id2"], max_groups=1 << 16)),
    ])
