"""arrow_tpu_torch.acero — the streaming query engine (Acero analog).

Public surface mirrors pyarrow.acero: Declaration + node options, plus
table-level helpers (group_by / sort_by / filter) that pyarrow implements
over acero (``python/pyarrow/acero.py:82,390,412``).
"""

from .plan import Declaration, declaration_to_table  # noqa: F401
from .options import (  # noqa: F401
    AggregateNodeOptions, AsofJoinNodeOptions, ExecNodeOptions,
    FetchNodeOptions, FilterNodeOptions, HashJoinNodeOptions,
    OrderByNodeOptions, PivotLongerNodeOptions, ProjectNodeOptions,
    RecordBatchReaderSourceNodeOptions, RecordBatchSourceNodeOptions,
    ScanNodeOptions, SortedMergeNodeOptions, SourceNodeOptions,
    TableSourceNodeOptions, TpchGenNodeOptions, UnionNodeOptions,
)
from ..ops.hash_aggregate import AggregateSpec  # noqa: F401
from ..ops.sorting import SortKey  # noqa: F401


def group_by(table, keys, aggregates, max_groups: int = 1 << 16,
             max_batch_rows: int = 1 << 15):
    """Table.group_by equivalent (pyarrow acero.py:412 _group_by)."""
    decl = Declaration.from_sequence([
        Declaration("table_source",
                    TableSourceNodeOptions(table, max_batch_rows)),
        Declaration("aggregate",
                    AggregateNodeOptions(aggregates, keys,
                                         max_groups=max_groups)),
    ])
    return decl.to_table()


def sort_by(table, sort_keys, null_placement: str = "at_end"):
    """Table.sort_by equivalent (pyarrow acero.py:390)."""
    decl = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(table)),
        Declaration("order_by", OrderByNodeOptions(sort_keys,
                                                   null_placement)),
    ])
    return decl.to_table()


def filter_table(table, expression):
    decl = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(table)),
        Declaration("filter", FilterNodeOptions(expression)),
    ])
    return decl.to_table()
