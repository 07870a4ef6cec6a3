"""Streaming, skew-immune distributed grouped aggregation; the counterpart
of the JAX package's ``parallel/dist_agg.py``.

  1. **Local pre-aggregation**: each shard consumes its stream of local
     batches into a per-shard HashAggregate state — no data movement at
     all during the stream.
  2. **State-row exchange**: at finalize, each shard's per-group state
     ROWS (unique keys + one row per aggregator state leaf) are exchanged
     by key hash. A key that appears on every shard costs exactly one row
     per shard, so Zipf-skewed DATA cannot overflow the exchange (the
     combiner argument), unlike a raw-row shuffle where one hot key funnels
     its whole mass into one bucket.
  3. **Merge**: the receiving shard folds the rows with
     ``HashAggregate.merge_rows``.

Requires every aggregator's state to be one row per group
(``GroupedAggregator.dist_rows``); ``DistContext.group_by`` falls back to
the raw-row shuffle for the rest. Varlen and dictionary keys are not
exchanged yet (ROADMAP queue item A3).

The state is a list with one HashAggregate state per shard, each on its
shard's device. ``state_from_numpy`` / ``state_to_numpy`` carry it from and
to the JAX package's packed form.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..compute.expressions import Expression, execute_scalar_expression
from ..core import datatype as dt
from ..core.array import Array
from ..core.batch import Batch, Table
from ..core.schema import Schema
from ..ops.aggregates import GroupedSum
from ..ops.hash_aggregate import AggregateSpec, HashAggregate
from ..ops.hashing import hash32
from ..ops.selection import filter_batch
from .shuffle import shuffle_rows

__all__ = ["DistGroupBy", "state_from_numpy", "state_to_numpy"]

# decorrelated from the row-shuffle seed AND the grouper hash
_STATE_EXCHANGE_SEED = 0x1B873593


class DistGroupBy:
    """Streaming distributed grouped aggregation over a 1-D mesh.

    Usage::

        dgb = DistGroupBy(ctx, schema, ["k"], [("sum", "v")])
        state = dgb.init_state()
        for batch in stream:            # each batch split over the mesh
            state = dgb.consume(state, batch)
        table = dgb.finalize_table(state)
    """

    def __init__(self, ctx, schema: Schema, keys: Sequence[str],
                 aggregates: Sequence, max_groups_per_shard: int = 1 << 14,
                 pre_filter: Optional[Expression] = None):
        self.ctx = ctx
        self.n = ctx.n
        self.schema = schema
        self.pre_filter = pre_filter
        aggs = [a if isinstance(a, AggregateSpec) else AggregateSpec(*a)
                for a in aggregates]
        self.ha = HashAggregate(schema, keys, aggs,
                                max_groups=max_groups_per_shard)
        if not self.ha.supports_state_exchange:
            raise ValueError(
                "DistGroupBy needs row-shaped aggregator states "
                "(GroupedAggregator.dist_rows); use DistContext.group_by "
                "which falls back to the raw-row shuffle")
        for f in self.ha.key_fields:
            if f.type.is_varlen or isinstance(f.type, dt.DictionaryType):
                raise NotImplementedError(
                    f"distributed group-by over {f.type} keys (ROADMAP "
                    "queue item A3)")
        self.G = max_groups_per_shard
        # the aggregator states' structure (a tuple of tensors or one
        # tensor each), on zero-row tensors
        self._agg_template = tuple(
            type(a)(a.in_type, 0, a.options).init("cpu")
            for a in self.ha._aggregators)

    # ------------------------------------------------------------------
    def _init_full_state(self, device):
        """One shard's empty state, the unique-key buffers included, so the
        state has one structure from init through every consume."""
        uniques = tuple(
            Array(f.type,
                  torch.from_numpy(np.zeros((self.G,), f.type.storage_np))
                  .to(device),
                  torch.zeros((self.G,), dtype=torch.bool, device=device))
            for f in self.ha.key_fields)
        grouper_state, agg_states, _ = self.ha.init_state(device)
        return (grouper_state, agg_states, uniques)

    def init_state(self) -> list:
        """Per-shard init states, each on its shard's device."""
        return [self._init_full_state(dev) for dev in self.ctx.devices]

    # ------------------------------------------------------------------
    def consume(self, state: list, b) -> list:
        """Consume one batch (split over the mesh if it is not yet) into
        the per-shard local states. Pure local compute: every shard
        filters its block and folds it into its own state."""
        b = self.ctx._sharded(b)
        return [self._consume_local(st, local)
                for st, local in zip(state, b.shards)]

    def _consume_local(self, st, local: Batch):
        if self.pre_filter is not None:
            mask = execute_scalar_expression(self.pre_filter, local)
            local = filter_batch(local, mask)
        return self.ha.consume(st, local)

    # ------------------------------------------------------------------
    def _state_rows(self, st):
        """Per shard, before the exchange: (leaves, dest, local error). The
        rows to exchange are the unique keys' (values, validity) and every
        aggregator state leaf, G rows each; row g goes to shard
        hash(key g) mod n, rows past the shard's group count nowhere."""
        grouper_state, agg_states, uniques = st
        h = hash32(list(uniques), seed=_STATE_EXCHANGE_SEED)
        gidx = torch.arange(self.G, device=h.device)
        dest = torch.where(gidx < grouper_state.num_groups, h % self.n,
                           self.n)
        leaves = []
        for u in uniques:
            leaves += [u.values, u.validity_or_true()]
        for agg_st in agg_states:
            leaves += list(agg_st) if isinstance(agg_st, tuple) else [agg_st]
        return leaves, dest, grouper_state.error

    def _merge_received(self, device, recv, total):
        """Per shard, after the exchange: fold the received state rows into
        a fresh state and finalize. Returns (result Batch, merge error)."""
        ha = self.ha
        it = iter(recv)
        o_keys = [Array(f.type, next(it), next(it)) for f in ha.key_fields]
        o_agg_states = []
        for agg_st in self._agg_template:
            o_agg_states.append(
                tuple(next(it) for _ in agg_st) if isinstance(agg_st, tuple)
                else next(it))
        merged = ha.merge_rows(self._init_full_state(device), o_keys,
                               tuple(o_agg_states), total)
        return ha.finalize(merged), merged[0].error

    def finalize_table(self, state: list) -> Table:
        """Exchange + merge + collect per-shard disjoint group tables.

        Bucket capacity G: a shard sends at most G rows in all, so no
        bucket can overflow and the exchange is overflow-free by
        construction; only more than G distinct keys on one shard can
        raise the error (in the consume before, or in the merge)."""
        ctx = self.ctx
        leaves, dests, local_errs = [], [], []
        for st in state:
            lv, dest, err = self._state_rows(st)
            leaves.append(lv)
            dests.append(dest)
            local_errs.append(err)
        received = shuffle_rows(leaves, dests, self.G, ctx.devices)
        del leaves, dests
        outs, errs = [], []
        for s, dev in enumerate(ctx.devices):
            recv, total, x_err = received[s]
            received[s] = None
            out, m_err = self._merge_received(dev, recv, total)
            outs.append(out)
            errs.append((local_errs[s] | x_err | m_err).to(torch.int32))
        return ctx._collect_shards(self.ha.out_schema, outs,
                                   ctx.fetch(errs), "group_by",
                                   "raise max_groups_per_shard")


# ---- the state, from and to the JAX package's packed form ---------------------
#
# The JAX DistGroupBy state is the tuple of the state pytree's leaves, each
# concatenated over the shards along axis 0 (scalars as one element per
# shard), in tree_leaves order: the grouper's table_lanes (u32), table_gid,
# num_groups, error; every aggregator state leaf; per key column the unique
# buffer's values, validity and length.

def _unsigned_sum(agg) -> bool:
    return isinstance(agg, GroupedSum) and agg._acc_dtype == torch.int64 \
        and agg.out_type == dt.uint64


def state_from_numpy(dgb: DistGroupBy, leaves) -> List:
    """The port's per-shard states from the JAX ``DistGroupBy`` state whose
    leaves were fetched as numpy; shard s's state lands on shard s's
    device."""
    n = dgb.n
    per_shard = [np.split(np.asarray(leaf), n) for leaf in leaves]
    out = []
    for s, dev in enumerate(dgb.ctx.devices):
        it = iter(leaf[s] for leaf in per_shard)
        gs = SimpleNamespace(table_lanes=next(it), table_gid=next(it),
                             num_groups=next(it).reshape(()),
                             error=next(it).reshape(()))
        aggs = tuple(
            tuple(next(it) for _ in agg_st) if isinstance(agg_st, tuple)
            else next(it) for agg_st in dgb._agg_template)
        uniques = []
        for _ in dgb.ha.key_fields:
            uniques.append(SimpleNamespace(values=next(it),
                                           validity=next(it)))
            next(it)                                    # the length leaf
        out.append(dgb.ha.state_from_numpy((gs, aggs, tuple(uniques)), dev))
    return out


def state_to_numpy(dgb: DistGroupBy, state: List) -> tuple:
    """The JAX ``DistGroupBy`` state (numpy leaves) of the port's per-shard
    states."""
    def host(t):
        return np.atleast_1d(t.cpu().numpy())

    shards = []
    for gs, agg_states, uniques in state:
        leaves = [host(gs.table_lanes).astype(np.uint32), host(gs.table_gid),
                  host(gs.num_groups), host(gs.error)]
        for agg, agg_st in zip(dgb.ha._aggregators, agg_states):
            sts = [host(x) for x in
                   (agg_st if isinstance(agg_st, tuple) else (agg_st,))]
            if _unsigned_sum(agg):
                sts[0] = sts[0].view(np.uint64)
            leaves += sts
        for u in uniques:
            leaves += [host(u.values), host(u.validity_or_true()),
                       np.array([u.capacity], np.int32)]
        shards.append(leaves)
    return tuple(np.concatenate(parts) for parts in zip(*shards))
