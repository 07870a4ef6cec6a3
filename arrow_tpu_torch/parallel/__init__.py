"""Distributed execution over a single-controller mesh: the exchange, the
distributed group-by and its streaming state-row form."""

from .context import DistContext, Mesh, ShardedBatch
from .dist_agg import DistGroupBy

__all__ = ["DistContext", "DistGroupBy", "Mesh", "ShardedBatch"]
