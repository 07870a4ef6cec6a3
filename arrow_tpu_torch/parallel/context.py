"""Distributed execution context: a mesh + table operations over it.

The counterpart of the JAX package's ``parallel/context.py``. That package
is single-controller SPMD: one process, ``shard_map`` over n devices. So is
this one: a ``Mesh`` is an ordered list of n ``torch.device``s under an axis
name, **which may repeat one device** (n logical shards on one card, or on
the CPU), one process runs each shard's step in turn on that shard's
device, and the shards meet only in ``parallel/shuffle.exchange``.

Layout: a distributed table is a ``ShardedBatch``: the rows of a Batch in
contiguous blocks of ``capacity / n`` rows, one local Batch per shard on
its device; each shard's local length follows from the global length and
its index.

``join`` and ``sort_by``, the distributed forms of the join and sort
operators (ROADMAP queue items A6 and A5, which are ported), come with queue
item A8b.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..compute.expressions import Expression, execute_scalar_expression
from ..core.array import Array
from ..core.batch import Batch, Table, empty_batch
from ..core.schema import Schema
from ..ops.hash_aggregate import AggregateSpec, HashAggregate
from ..ops.selection import filter_batch
from .shuffle import shuffle_batch

__all__ = ["DistContext", "Mesh", "ShardedBatch"]


class Mesh:
    """An ordered list of devices, one per shard, under one axis name."""

    def __init__(self, devices: Sequence, axis: str = "d"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    def __repr__(self) -> str:
        return f"Mesh({self.axis}={[str(d) for d in self.devices]})"


class ShardedBatch:
    """A Batch split over a mesh: ``shards[s]`` holds rows
    [s * local_capacity, (s + 1) * local_capacity) on ``mesh.devices[s]``,
    with its local length; ``length`` is the global length."""

    def __init__(self, mesh: Mesh, schema: Schema, shards: List[Batch],
                 length):
        self.mesh = mesh
        self.schema = schema
        self.shards = list(shards)
        self.length = length

    @property
    def local_capacity(self) -> int:
        return self.shards[0].capacity

    @property
    def capacity(self) -> int:
        return self.local_capacity * len(self.shards)

    def __len__(self) -> int:
        return int(self.length)


def _slice_rows(t: torch.Tensor, lo: int, hi: int, device) -> torch.Tensor:
    """Rows [lo, hi) of ``t`` on ``device``, zero-padded past its end."""
    part = t[lo:min(hi, t.shape[0])]
    short = (hi - lo) - part.shape[0]
    if short:
        part = torch.cat([part, part.new_zeros((short,) + part.shape[1:])])
    return part.to(device)


def _with_validity(b: Batch, length: int) -> Batch:
    """``b`` with every validity buffer present and a host length."""
    return Batch(b.schema, [Array(a.type, a.values, a.validity_or_true(),
                                  length=length) for a in b.arrays], length)


class DistContext:
    """Single-controller loop over a 1-D data mesh."""

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "d",
                 devices=None):
        if mesh is None:
            if devices is None:
                # the default is the cards, as every entry point's is
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
                if not devices:
                    raise RuntimeError(
                        "DistContext: no CUDA device; pass devices=[...] "
                        "(a device may repeat: logical shards)")
            mesh = Mesh(devices, axis)
        self.mesh = mesh
        self.axis = mesh.axis
        self.n = mesh.shape[self.axis]

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.devices

    def fetch(self, tensors: Sequence[torch.Tensor]) -> np.ndarray:
        """The shards' equal-shaped small tensors (error flags, lengths) as
        one numpy array with a leading shard axis: gathered on the first
        shard's device, then ONE copy to the host."""
        dev = tensors[0].device
        return torch.stack([t.to(dev) for t in tensors]).cpu().numpy()

    # -------------------------------------------------------------------
    def shard_batch(self, b: Batch) -> ShardedBatch:
        """Pad the capacity to a multiple of n and split the row buffers
        into contiguous blocks, block s on shard s's device (a view where
        that is the batch's own device and no padding is needed)."""
        n = self.n
        cap = b.capacity
        local_cap = (cap + (-cap) % n) // n
        shards = []
        for s, dev in enumerate(self.devices):
            lo, hi = s * local_cap, (s + 1) * local_cap
            if b.has_static_length:
                local_len = min(max(int(b.length) - lo, 0), local_cap)
            else:
                local_len = torch.clamp(b.length.to(dev) - lo, 0, local_cap)
            arrays = []
            for i in range(b.num_columns):
                a = b.column(i)
                if a.type.is_varlen:
                    raise NotImplementedError(
                        "distributed varlen columns: dictionary-encode first")
                arrays.append(Array(
                    a.type, _slice_rows(a.values, lo, hi, dev),
                    None if a.validity is None
                    else _slice_rows(a.validity, lo, hi, dev),
                    length=local_len))
            shards.append(Batch(b.schema, arrays, local_len))
        return ShardedBatch(self.mesh, b.schema, shards, b.length)

    def _is_sharded(self, b) -> bool:
        return isinstance(b, ShardedBatch) and b.mesh is self.mesh

    def _sharded(self, b) -> ShardedBatch:
        return b if self._is_sharded(b) else self.shard_batch(b)

    # -------------------------------------------------------------------
    def group_by(self, b, keys: Sequence[str], aggregates: Sequence,
                 max_groups_per_shard: int = 1 << 14,
                 pre_filter: Optional[Expression] = None,
                 bucket_factor: int = 2) -> Table:
        """Distributed grouped aggregation.

        Fast path (every aggregator state is one row per group): local
        pre-aggregation + state-row exchange + merge — skew-immune, one
        exchanged row per (shard, distinct key) (``parallel/dist_agg``).
        Fallback (``group_by_raw_rows``): raw-row hash shuffle, then local
        aggregation — subject to ``bucket_factor`` capacity under key skew.
        """
        b = self._sharded(b)
        aggs = [a if isinstance(a, AggregateSpec) else AggregateSpec(*a)
                for a in aggregates]
        ha = HashAggregate(b.schema, keys, aggs,
                           max_groups=max_groups_per_shard)
        if ha.supports_state_exchange:
            from .dist_agg import DistGroupBy
            dgb = DistGroupBy(self, b.schema, keys, aggs,
                              max_groups_per_shard=max_groups_per_shard,
                              pre_filter=pre_filter)
            state = dgb.consume(dgb.init_state(), b)
            return dgb.finalize_table(state)
        return self.group_by_raw_rows(b, keys, aggs, max_groups_per_shard,
                                      pre_filter, bucket_factor)

    def group_by_raw_rows(self, b, keys: Sequence[str],
                          aggregates: Sequence,
                          max_groups_per_shard: int = 1 << 14,
                          pre_filter: Optional[Expression] = None,
                          bucket_factor: int = 2) -> Table:
        """The fallback of ``group_by`` for aggregator states that are not
        row-shaped: every shard filters its block, the raw rows shuffle by
        key hash (buckets of ``bucket_factor`` x the local capacity), and
        each shard aggregates what it received. A bucket or group table
        that overflows retries at doubled capacities."""
        b = self._sharded(b)
        aggs = [a if isinstance(a, AggregateSpec) else AggregateSpec(*a)
                for a in aggregates]
        ha = HashAggregate(b.schema, keys, aggs,
                           max_groups=max_groups_per_shard)
        local_cap = b.local_capacity
        locals_ = []
        for local in b.shards:
            if pre_filter is not None:
                mask = execute_scalar_expression(pre_filter, local)
                local = filter_batch(local, mask)
            locals_.append(local)
        shuffled = shuffle_batch(locals_, keys, self.devices,
                                 bucket_capacity=bucket_factor * local_cap)
        del locals_
        outs, errs = [], []
        for s, dev in enumerate(self.devices):
            received, err = shuffled[s]
            shuffled[s] = None
            state = ha.consume(ha.init_state(dev), received)
            outs.append(ha.finalize(state))
            errs.append(err | state[0].error)

        errs_host = self.fetch(errs)
        if errs_host.any():
            # the sharded input is still at hand, so an overflow (shuffle
            # bucket or group table) retries at doubled capacities
            nb = bucket_factor * 2 if bucket_factor * 2 <= 4 * self.n \
                else bucket_factor
            ng = max_groups_per_shard * 2 \
                if max_groups_per_shard * 2 <= (1 << 24) \
                else max_groups_per_shard
            if (nb, ng) != (bucket_factor, max_groups_per_shard):
                return self.group_by_raw_rows(
                    b, keys, aggs, max_groups_per_shard=ng,
                    pre_filter=pre_filter, bucket_factor=nb)
        return self._collect_shards(
            ha.out_schema, outs, errs_host, "group_by",
            "raise max_groups_per_shard/bucket_factor or repartition "
            "skewed keys")

    # -------------------------------------------------------------------
    def join(self, left, right, options, bucket_factor: int = 2,
             fanout_per_shard: Optional[int] = None) -> Table:
        raise NotImplementedError(
            "DistContext.join, the distributed form of the hash join (queue "
            "item A6), is not ported yet (ROADMAP queue item A8b)")

    def sort_by(self, b, sort_keys, bucket_factor: int = 3,
                samples_per_shard: int = 256) -> Table:
        raise NotImplementedError(
            "DistContext.sort_by, the distributed form of the sort (queue "
            "item A5), is not ported yet (ROADMAP queue item A8b)")

    # -------------------------------------------------------------------
    def _collect_shards(self, schema: Schema, outs: Sequence[Batch],
                        errs_host: np.ndarray, what: str,
                        hint: str = "raise bucket_factor/capacities or "
                        "repartition skewed keys") -> Table:
        """The shards' result batches as one Table: one batch per shard
        that has rows, in shard order, each left on its device."""
        if errs_host.any():
            raise RuntimeError(
                f"distributed {what} overflow (per-shard errors="
                f"{errs_host.tolist()}): {hint}")
        lengths = [torch.as_tensor(o.length, device=o.device) for o in outs]
        lengths_host = self.fetch(lengths)
        batches = [_with_validity(o, int(ln))
                   for o, ln in zip(outs, lengths_host) if int(ln)]
        if not batches:
            batches = [empty_batch(schema, device=self.devices[0])]
        return Table(schema, batches)
