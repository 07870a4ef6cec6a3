"""arrow_tpu_torch.acero: the node options of the streaming query engine
(Acero analog). The plan and its nodes come with ROADMAP queue item A7."""

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
