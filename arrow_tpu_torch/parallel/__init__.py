"""Distributed execution over a mesh of shards, in one process or across
processes (``multihost``): the exchange, the distributed group-by, join
and sort, and the streaming forms of the group-by and the join that the
plan nodes use."""

from . import multihost
from .context import DistContext, Mesh, ShardedBatch
from .dist_agg import DistGroupBy
from .dist_join import DistHashJoin
from .shuffle import partition_for_exchange, shuffle_batch, shuffle_rows

__all__ = ["DistContext", "DistGroupBy", "DistHashJoin", "Mesh",
           "ShardedBatch", "multihost", "partition_for_exchange",
           "shuffle_batch", "shuffle_rows"]
