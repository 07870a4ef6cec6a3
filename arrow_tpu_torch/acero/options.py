"""Per-node options (reference: ``cpp/src/arrow/acero/options.h``); the
same classes as the JAX package's ``acero/options.py``, read by the nodes
of ``acero/nodes.py``."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..compute.expressions import Expression
from ..ops.hash_aggregate import AggregateSpec
from ..ops.sorting import SortKey

__all__ = [
    "ExecNodeOptions", "TableSourceNodeOptions", "SourceNodeOptions",
    "RecordBatchSourceNodeOptions", "RecordBatchReaderSourceNodeOptions",
    "FilterNodeOptions", "ProjectNodeOptions", "AggregateNodeOptions",
    "OrderByNodeOptions", "FetchNodeOptions", "UnionNodeOptions",
    "HashJoinNodeOptions", "TpchGenNodeOptions",
    "SortedMergeNodeOptions", "AsofJoinNodeOptions",
    "PivotLongerNodeOptions", "ScanNodeOptions",
]


class ExecNodeOptions:
    pass


class TableSourceNodeOptions(ExecNodeOptions):
    """Feed an in-memory table (arrow_tpu_torch.Table or pyarrow.Table),
    sliced into <=max_batch_rows batches (ExecPlan::kMaxBatchSize analog)."""

    def __init__(self, table, max_batch_rows: int = 1 << 15):
        self.table = table
        self.max_batch_rows = max_batch_rows


class SourceNodeOptions(ExecNodeOptions):
    """Feed from a generator of Batches (AsyncGenerator<ExecBatch> analog,
    ``source_node.cc:96``)."""

    def __init__(self, schema, generator: Callable[[], Iterable]):
        self.schema = schema
        self.generator = generator


class RecordBatchSourceNodeOptions(ExecNodeOptions):
    """Feed from an iterable of record batches (pyarrow.RecordBatch or
    arrow_tpu_torch.Batch) — ``source_node.cc:303`` RecordBatchSourceNode."""

    def __init__(self, schema, batches):
        self.schema = schema
        self.batches = batches


class RecordBatchReaderSourceNodeOptions(ExecNodeOptions):
    """Feed from a pyarrow.RecordBatchReader (``source_node.cc:372``)."""

    def __init__(self, reader):
        self.reader = reader


class FilterNodeOptions(ExecNodeOptions):
    def __init__(self, filter_expression: Expression):
        self.filter_expression = filter_expression


class ProjectNodeOptions(ExecNodeOptions):
    def __init__(self, expressions: Sequence[Expression],
                 names: Optional[Sequence[str]] = None):
        self.expressions = list(expressions)
        self.names = list(names) if names is not None else None


class AggregateNodeOptions(ExecNodeOptions):
    """aggregates: list of AggregateSpec or (function, target, options,
    name) tuples; keys empty => scalar aggregation."""

    def __init__(self, aggregates: Sequence, keys: Sequence[str] = (),
                 segment_keys: Sequence[str] = (),
                 max_groups: int = 1 << 16,
                 dist=None):
        self.aggregates = [
            a if isinstance(a, AggregateSpec) else AggregateSpec(*a)
            for a in aggregates]
        # segment keys (ordered-stream aggregation, RowSegmenter role,
        # ``grouper.h:78``): the sort-grouped consume already bounds
        # memory per distinct key, so segments simply lead the key list —
        # output order (first appearance) equals stream-segment order on
        # sorted input.
        self.segment_keys = list(segment_keys)
        self.keys = list(segment_keys) + [k for k in keys
                                          if k not in set(segment_keys)]
        self.max_groups = max_groups
        # DistContext: run the keyed aggregation SPMD over the mesh
        # (streaming local pre-aggregation + state-row exchange + Merge,
        # parallel/dist_agg). max_groups then bounds PER-SHARD groups.
        self.dist = dist


class OrderByNodeOptions(ExecNodeOptions):
    def __init__(self, sort_keys: Sequence, null_placement: str = "at_end",
                 spill_bytes: Optional[int] = None):
        self.sort_keys = [k if isinstance(k, SortKey) else SortKey(*k)
                          for k in sort_keys]
        self.null_placement = null_placement
        # device-byte budget before switching to the external sort
        # (acero/spill.py); None -> ARROW_TPU_SPILL_BYTES env, else
        # unbounded in-memory accumulation
        self.spill_bytes = spill_bytes


class FetchNodeOptions(ExecNodeOptions):
    def __init__(self, offset: int, count: int):
        self.offset = offset
        self.count = count


class UnionNodeOptions(ExecNodeOptions):
    pass


class HashJoinNodeOptions(ExecNodeOptions):
    """Reference: ``acero/options.h`` HashJoinNodeOptions."""

    def __init__(self, join_type: str = "inner",
                 left_keys: Sequence[str] = (),
                 right_keys: Sequence[str] = (),
                 left_output: Optional[Sequence[str]] = None,
                 right_output: Optional[Sequence[str]] = None,
                 output_suffix_for_left: str = "",
                 output_suffix_for_right: str = "",
                 max_build_rows: int = 1 << 20,
                 fanout_capacity: Optional[int] = None,
                 filter=None,
                 dist=None,
                 disable_bloom_filter: bool = False,
                 spill_bytes: Optional[int] = None):
        assert join_type in ("inner", "left outer", "right outer",
                             "full outer", "left semi", "right semi",
                             "left anti", "right anti")
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        # [] is meaningful ("emit NO columns from this side" — e.g. the
        # probe side of a semi-join-shaped inner join); only None means
        # "all columns"
        self.left_output = list(left_output) if left_output is not None \
            else None
        self.right_output = list(right_output) if right_output is not None \
            else None
        self.output_suffix_for_left = output_suffix_for_left
        self.output_suffix_for_right = output_suffix_for_right
        self.max_build_rows = max_build_rows
        self.fanout_capacity = fanout_capacity
        # residual (non-equi) filter evaluated on matched key pairs —
        # ``acero/options.h:571`` (Expression filter, default
        # literal(true)). Field refs resolve by name against the left
        # then the right input schema; a name present in both is an
        # error (acero resolves ambiguity the same way: bind fails).
        self.filter = filter
        # DistContext: run this join SPMD over the mesh (co-partitioning
        # all_to_all shuffle + per-shard build/probe, parallel/dist_join;
        # the exchange-operator role Acero lacks — overview.rst:99-110).
        # max_build_rows then bounds the PER-SHARD build side.
        self.dist = dist
        # ``options.h:682``: whether to disable Bloom pushdown (the
        # probe-side pre-filter + host re-bucket; ops/bloom.py).
        self.disable_bloom_filter = disable_bloom_filter
        # build-side device-byte budget before switching to the Grace
        # (disk-partitioned) join — acero/spill.py; None -> the
        # ARROW_TPU_SPILL_BYTES env, else unbounded accumulation
        self.spill_bytes = spill_bytes


class TpchGenNodeOptions(ExecNodeOptions):
    """Reference: TpchGenNodeOptions (``acero/tpch_node.h``)."""

    def __init__(self, table_name: str, scale_factor: float = 1.0,
                 seed: int = 42, max_batch_rows: int = 1 << 15,
                 device=None, columns=None):
        self.table_name = table_name
        self.scale_factor = scale_factor
        self.seed = seed
        self.max_batch_rows = max_batch_rows
        # where the generated batches go (None: the default device)
        self.device = device
        # the columns to generate, as the reference's TpchGen takes them
        # (None: all; the plan's projection pushdown sets them)
        self.columns = None if columns is None else list(columns)


class SortedMergeNodeOptions(ExecNodeOptions):
    """Reference: ``sorted_merge_node.cc:256`` — merge N inputs that are
    each ordered by sort_keys into one ordered stream."""

    def __init__(self, sort_keys: Sequence, null_placement: str = "at_end"):
        self.sort_keys = [k if isinstance(k, SortKey) else SortKey(*k)
                          for k in sort_keys]
        self.null_placement = null_placement


class AsofJoinNodeOptions(ExecNodeOptions):
    """Reference: ``asof_join_node.cc`` AsofJoinNodeOptions.

    tolerance < 0: match the nearest right.on <= left.on with
    left.on - right.on <= |tolerance|; tolerance >= 0: the nearest
    right.on >= left.on with right.on - left.on <= tolerance (pyarrow
    semantics, verified against the oracle)."""

    def __init__(self, left_on: str, left_by: Sequence[str],
                 right_on: str, right_by: Sequence[str], tolerance: int,
                 max_by_groups: int = 1 << 16):
        self.left_on = left_on
        self.left_by = list(left_by)
        self.right_on = right_on
        self.right_by = list(right_by)
        self.tolerance = tolerance
        self.max_by_groups = max_by_groups


class PivotLongerNodeOptions(ExecNodeOptions):
    """Reference: ``pivot_longer_node.cc:74``. Each row template emits one
    output row per input row: feature columns are string literals naming
    the template, measurement columns reference an input field (or None
    => null)."""

    def __init__(self, feature_field_names: Sequence[str],
                 measurement_field_names: Sequence[str],
                 row_templates: Sequence):
        self.feature_field_names = list(feature_field_names)
        self.measurement_field_names = list(measurement_field_names)
        # row_templates: [(feature_values: [str], measurements: [str|None])]
        self.row_templates = list(row_templates)


class ScanNodeOptions(ExecNodeOptions):
    """Reference: ``dataset/scan_node.cc:123`` — scan a Dataset as a plan
    source with fragment pruning + residual filter pushdown."""

    def __init__(self, dataset, columns=None, filter=None,
                 batch_rows: int = 1 << 15, device=None):
        self.dataset = dataset
        self.columns = columns
        self.filter = filter
        self.batch_rows = batch_rows
        # where the scanned batches go (None: the default device)
        self.device = device
