"""Streaming distributed hash join (co-partitioned, for the plan node); the
counterpart of the JAX package's ``parallel/dist_join.py``.

The reference's partitioned build (``swiss_join_internal.h:524``) with the
exchange as the partitioner and no merge phase: the results stay
partitioned. The shape follows the one-device plan node:

  build phase:  each build-side batch shuffles by its join keys and is
                appended to a per-shard accumulation buffer of
                ``max_build_rows`` rows (the pipeline-breaker side).
  finish_build: one ``HashJoin.build`` per shard over what it holds.
  probe phase:  each probe-side batch shuffles by its keys with the SAME
                seed (co-partitioned: equal keys meet on one shard), is
                probed on each shard, and its per-shard outputs stream out.
  finish:       the right / full outer and right semi / anti tails, which
                are shard-local (every build row lives on one shard).

The state is a list with one entry per shard of this process, each on its
shard's device; nothing is compiled. A probe batch costs one host read (the
shards' output lengths), ``finish`` one (errors and tail lengths
together); across processes each read is one collective, and every
process yields every shard's output rows (``DistContext.shard_results``).

Dictionary columns: the accumulation holds a build column's codes, and
each side's dictionaries are captured by name, the first seen, as in the
JAX package (which keeps one map for both sides:
``context.join_dictionaries`` says where the two differ). Unlike the JAX
package, whose shard-local batches carry no dictionary (so that its keys
match by code: ROADMAP C21), every shard's build and probe batch keeps
its dictionary, so the co-partitioning hash and the per-shard join key by
the content the codes name, and two sides with different dictionaries
join by value. The outputs carry the dictionaries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.array import Array
from ..core.batch import Batch
from ..core.schema import Schema
from ..ops.bits import as_signed_bits
from ..ops.join import BuildState, HashJoin
from ..ops.kernel_utils import torch_dtype
from .context import capture_dictionaries, join_dictionaries
from .shuffle import shuffle_batch

__all__ = ["DistHashJoin"]


class _BuildAccum:
    """One shard's build accumulation: a values and a validity buffer of
    ``cap + 1`` rows per column (row ``cap`` is the slot that rows past the
    capacity are written to and dropped from), the rows held (0-d int32)
    and the error flag (0-d int32)."""

    def __init__(self, schema: Schema, cap: int, device):
        for f in schema.fields:
            if f.type.is_varlen:
                raise NotImplementedError(
                    "distributed varlen build columns: dictionary-encode "
                    "first (DistContext.shard_batch restriction)")
        self.cap = cap
        self.values = [torch.zeros((cap + 1,), dtype=torch_dtype(f.type),
                                   device=device) for f in schema.fields]
        self.validity = [torch.zeros((cap + 1,), dtype=torch.bool,
                                     device=device) for _ in schema.fields]
        self.length = torch.zeros((), dtype=torch.int32, device=device)
        self.error = torch.zeros((), dtype=torch.int32, device=device)

    def append(self, b: Batch, err: torch.Tensor) -> None:
        """Append the rows of ``b`` (length on the device) after the rows
        held; rows past the capacity drop and set the error flag."""
        ridx = torch.arange(b.capacity, dtype=torch.int32, device=b.device)
        pos = self.length + ridx
        pos = torch.where((ridx < b.length) & (pos < self.cap), pos,
                          self.cap).long()
        for i, a in enumerate(b.arrays):
            as_signed_bits(self.values[i]).index_copy_(
                0, pos, as_signed_bits(a.values))
            self.validity[i].index_copy_(0, pos, a.validity_or_true())
        new_len = self.length + b.length
        self.error = self.error | err.to(torch.int32) | \
            (new_len > self.cap).to(torch.int32)
        self.length = torch.clamp(new_len, max=self.cap).to(torch.int32)

    def batch(self, schema: Schema, dicts) -> Batch:
        """The rows held, column i's codes read through ``dicts[i]``."""
        return Batch(schema, [
            Array(f.type, v[:self.cap], m[:self.cap], length=self.length,
                  dictionary=d)
            for f, v, m, d in zip(schema.fields, self.values, self.validity,
                                  dicts)], self.length)


class DistHashJoin:
    """Streaming distributed hash join over a 1-D mesh.

    Usage::

        dhj = DistHashJoin(ctx, left_schema, right_schema, options)
        bs = dhj.init_build()
        for b in build_stream:
            bs = dhj.consume_build(bs, b)
        ps = dhj.finish_build(bs)
        for b in probe_stream:
            out_batches, ps = dhj.probe(ps, b)
        tail_batches = dhj.finish(ps)

    The probe takes the generic ``"sort"`` route on every shard, as the
    JAX package's distributed probe does (it passes no ``impl``)."""

    def __init__(self, ctx, left_schema: Schema, right_schema: Schema,
                 options, bucket_factor: int = 2,
                 fanout_per_shard: Optional[int] = None):
        self.ctx = ctx
        self.n = ctx.n
        self.right_schema = right_schema
        self.bucket_factor = bucket_factor
        self.hj = HashJoin(left_schema, right_schema, options)
        # per-shard accumulation capacity of the shuffled build side
        self.build_cap = options.max_build_rows
        self.fanout = fanout_per_shard
        # per shard, the dictionaries of the build and of the probe
        # batches' dictionary columns by name, the first seen
        self._build_dicts = [{} for _ in ctx.devices]
        self._probe_dicts = [{} for _ in ctx.devices]

    @staticmethod
    def _capture_dicts(dicts, b) -> None:
        for by_name, local in zip(dicts, b.shards):
            capture_dictionaries(by_name, local)

    # ------------------------------------------------------------------
    def init_build(self) -> List[_BuildAccum]:
        """Per-shard empty accumulations, each on its shard's device."""
        return [_BuildAccum(self.right_schema, self.build_cap, dev)
                for dev in self.ctx.devices]

    def consume_build(self, state: List[_BuildAccum], b
                      ) -> List[_BuildAccum]:
        """Shuffle one build batch by its keys (buckets of
        ``bucket_factor`` x the local capacity) and append on each shard.
        No host read."""
        b = self.ctx._sharded(b)
        self._capture_dicts(self._build_dicts, b)
        shuffled = shuffle_batch(
            b.shards, self.hj.right_keys, self.ctx.devices,
            bucket_capacity=self.bucket_factor * b.local_capacity,
            group=self.ctx.group)
        for s, acc in enumerate(state):
            shuf, err = shuffled[s]
            shuffled[s] = None
            acc.append(shuf, err)
        return state

    def finish_build(self, state: List[_BuildAccum]) -> List[BuildState]:
        """One build per shard over the accumulated co-partitioned rows,
        with the accumulation's error folded in."""
        return [self.hj.build(acc.batch(self.right_schema, [
            d.get(f.name) for f in self.right_schema.fields]))
            ._with_error(acc.error)
            for acc, d in zip(state, self._build_dicts)]

    # ------------------------------------------------------------------
    def probe(self, pstate: List[BuildState], b
              ) -> Tuple[List[Batch], List[BuildState]]:
        """Shuffle one probe batch (the same seed as the build: equal keys
        on equal shards), probe each shard, and return that batch's
        per-shard outputs (shards with rows, in shard order; none for the
        right semi / anti joins) and the new states. A shuffle bucket or
        fanout overflow sets the shard's error, which ``finish`` raises."""
        b = self.ctx._sharded(b)
        self._capture_dicts(self._probe_dicts, b)
        local_cap = b.local_capacity
        fanout = self.fanout or max(2 * local_cap, 1 << 12)
        shuffled = shuffle_batch(
            b.shards, self.hj.left_keys, self.ctx.devices,
            bucket_capacity=self.bucket_factor * local_cap,
            group=self.ctx.group)
        outs, new_state = [], []
        for s, bs in enumerate(pstate):
            shuf, err = shuffled[s]
            shuffled[s] = None
            out, bs = self.hj.probe(bs, shuf, fanout_capacity=fanout)
            new_state.append(bs._with_error(err.to(torch.int32)))
            outs.append(out)
        if outs[0] is None:
            return [], new_state
        sizes = self.ctx.fetch(self.ctx.result_sizes(outs))
        return self._collect(outs, sizes), new_state

    def finish(self, pstate: List[BuildState]) -> List[Batch]:
        """Per-shard trailing rows; raises if any shard's build, exchange
        or fanout overflowed. One host read: the errors and the tails'
        lengths and capacities together."""
        tails = [self.hj.finish(bs) for bs in pstate]
        scalars = [bs.error.to(torch.int64) for bs in pstate]
        if tails[0] is not None:
            scalars += self.ctx.result_sizes(tails)
        host = self.ctx.fetch(scalars)
        errs = host[:self.n]
        if errs.any():
            raise RuntimeError(
                f"distributed join overflow (per-shard errors="
                f"{errs.tolist()}): raise max_build_rows/fanout_per_shard/"
                f"bucket_factor")
        if tails[0] is None:
            return []
        return self._collect(tails, host[self.n:])

    def _collect(self, outs: List[Batch], sizes: np.ndarray) -> List[Batch]:
        """Every shard's batch that holds rows, in shard order, with its
        host length (``sizes``: every shard's length, then capacity),
        every validity present and the captured dictionaries attached
        (``DistContext.shard_results``: across processes the other
        processes' shards' rows too)."""
        n = self.n
        return self.ctx.shard_results(
            self.hj.out_schema, outs, sizes[:n],
            [join_dictionaries(self.hj, pd, bd)
             for pd, bd in zip(self._probe_dicts, self._build_dicts)],
            sizes[n:])
