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
(``GroupedAggregator.dist_rows``): counts, sums, products, means, min /
max, any / all, variance / stddev / skew / kurtosis as (mean, M2[, M3,
M4], count), first / last / one as (row, value) and the decimal sum's
limbs; a state's 0-d leaves (first / last's row base) stay on their shard.
``DistContext.group_by`` falls back to the raw-row shuffle for the rest. A dictionary key's state rows carry its
codes: ``consume`` captures the key's dictionary (the last batch's, as the
JAX package does), and the exchange hashes, and the receiving shard
merges, the codes with it attached, so by the content they name. A raw
varlen key raises where the JAX package's does: at ``consume``'s
``shard_batch``.

The state is a list with one HashAggregate state per shard of this
process, each on its shard's device. ``state_from_numpy`` /
``state_to_numpy`` carry it from and to the JAX package's packed form
(this process's shards of it, across processes).
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
from ..ops.hash_aggregate import AggregateSpec, HashAggregate
from ..ops.hashing import hash32
from ..ops.selection import filter_batch
from .shuffle import dictionaries_on, shuffle_rows

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
        self.G = max_groups_per_shard
        # the aggregator states' structure (a tuple of tensors or one
        # tensor each), on zero-row tensors
        self._agg_template = tuple(
            type(a)(a.in_type, 0, a.options).init("cpu")
            for a in self.ha._aggregators)
        # per dictionary key column (by name), its dictionary on each
        # shard, captured at consume: the state rows carry the codes
        self._key_dicts = {}

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
        filters its block and folds it into its own state. Captures the
        batch's dictionary of each dictionary key (each shard's copy)."""
        b = self.ctx._sharded(b)
        for f in self.ha.key_fields:
            if isinstance(f.type, dt.DictionaryType):
                self._key_dicts[f.name] = [local.column(f.name).dictionary
                                           for local in b.shards]
        return [self._consume_local(st, local)
                for st, local in zip(state, b.shards)]

    def _consume_local(self, st, local: Batch):
        if self.pre_filter is not None:
            mask = execute_scalar_expression(self.pre_filter, local)
            local = filter_batch(local, mask)
        return self.ha.consume(st, local)

    # ------------------------------------------------------------------
    def _key_arrays(self, s: int, pairs) -> List[Array]:
        """This process's shard s's key columns of state rows from their
        (values, validity): a dictionary key's codes with the dictionary
        captured on shard s attached."""
        return [Array(f.type, v, m, dictionary=self._key_dicts[f.name][s]
                      if f.name in self._key_dicts else None)
                for f, (v, m) in zip(self.ha.key_fields, pairs)]

    def _state_rows(self, s: int, st):
        """Per shard, before the exchange: (leaves, dest, local error). The
        rows to exchange are the unique keys' (values, validity) and every
        aggregator state leaf, G rows each; row g goes to shard
        hash(key g) mod n (a dictionary key hashed by its content), rows
        past the shard's group count nowhere."""
        grouper_state, agg_states, uniques = st
        h = hash32(self._key_arrays(s, [(u.values, u.validity)
                                        for u in uniques]),
                   seed=_STATE_EXCHANGE_SEED)
        gidx = torch.arange(self.G, device=h.device)
        dest = torch.where(gidx < grouper_state.num_groups, h % self.n,
                           self.n)
        leaves = []
        for u in uniques:
            leaves += [u.values, u.validity_or_true()]
        for agg_st in agg_states:
            leaves += [x for x in _leaves(agg_st) if x.ndim]
        return leaves, dest, grouper_state.error

    def _merge_received(self, s: int, recv, total):
        """Per shard, after the exchange: fold the received state rows into
        a fresh state and finalize. Returns (result Batch, merge error)."""
        ha = self.ha
        it = iter(recv)
        o_keys = self._key_arrays(s, [(next(it), next(it))
                                      for _ in ha.key_fields])
        fresh = self._init_full_state(self.ctx.devices[s])
        o_agg_states = []
        for agg_st, init_st in zip(self._agg_template, fresh[1]):
            # row leaves from the exchange, 0-d ones from a fresh state
            got = [next(it) if x.ndim else y
                   for x, y in zip(_leaves(agg_st), _leaves(init_st))]
            o_agg_states.append(tuple(got) if isinstance(agg_st, tuple)
                                else got[0])
        merged = ha.merge_rows(fresh, o_keys, tuple(o_agg_states), total)
        return ha.finalize(merged), merged[0].error

    def finalize_table(self, state: list) -> Table:
        """Exchange + merge + collect per-shard disjoint group tables.

        Bucket capacity G: a shard sends at most G rows in all, so no
        bucket can overflow and the exchange is overflow-free by
        construction; only more than G distinct keys on one shard can
        raise the error (in the consume before, or in the merge)."""
        ctx = self.ctx
        leaves, dests, local_errs = [], [], []
        for s, st in enumerate(state):
            lv, dest, err = self._state_rows(s, st)
            leaves.append(lv)
            dests.append(dest)
            local_errs.append(err)
        received = shuffle_rows(leaves, dests, self.G, ctx.devices,
                                group=ctx.group)
        del leaves, dests
        outs, errs = [], []
        for s in range(len(state)):
            recv, total, x_err = received[s]
            received[s] = None
            out, m_err = self._merge_received(s, recv, total)
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

def _leaves(st) -> tuple:
    return st if isinstance(st, tuple) else (st,)


def state_from_numpy(dgb: DistGroupBy, leaves, dictionaries=None) -> List:
    """The port's per-shard states of this process's shards from the JAX
    ``DistGroupBy`` state (every shard's) whose leaves were fetched as
    numpy; global shard s's state lands on its device. The state holds a
    dictionary key's codes; ``dictionaries`` maps such a key's name to its
    dictionary (a port Array), which ``dgb`` captures as its ``consume``
    would."""
    n, devices = dgb.n, dgb.ctx.devices
    for name, d in (dictionaries or {}).items():
        dgb._key_dicts[name] = [
            ds[0] for ds in dictionaries_on([[d]] * len(devices), devices)]
    per_shard = [np.split(np.asarray(leaf), n) for leaf in leaves]
    first = dgb.ctx.mesh.first
    out = []
    for i, dev in enumerate(devices):
        it = iter(leaf[first + i] for leaf in per_shard)
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
    states (across processes: this process's shards' part, which the
    processes' parts concatenate to in rank order)."""
    def host(t):
        return np.atleast_1d(t.cpu().numpy())

    shards = []
    for gs, agg_states, uniques in state:
        leaves = [host(gs.table_lanes).astype(np.uint32), host(gs.table_gid),
                  host(gs.num_groups), host(gs.error)]
        for agg, agg_st in zip(dgb.ha._aggregators, agg_states):
            leaves += [np.atleast_1d(x) for x in agg.state_to_numpy(agg_st)]
        for u in uniques:
            leaves += [host(u.values), host(u.validity_or_true()),
                       np.array([u.capacity], np.int32)]
        shards.append(leaves)
    return tuple(np.concatenate(parts) for parts in zip(*shards))
