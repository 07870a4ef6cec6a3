"""The engine's flagship step: filter -> group-by, on one device and
distributed over a mesh.

The entry points return ``(step, (batch,))``. The one-device ``step``
evaluates the predicate ``w > 0``, filters the batch, routes the grouped
aggregation as the JAX package's ``AggregateNode._consume_any`` does (one
host read of the key range probe, then ``probe_route``), consumes and
finalizes.

  * ``entry(device, n_rows, num_keys, seed)``: the schema on which the
    dense route fires (int64 key ``k``, float32 ``v``, int64 ``w``). The
    filter is one pass of the stream-compaction kernel and the consume one
    pass of the dense group-by kernel.
  * ``entry_generic(device, n_rows, num_keys, seed, max_groups)``: the
    step as ``__graft_entry__.entry`` writes it for JAX (``v`` float64;
    sum(v), min(w), count_all). The filter builds take indices on the
    tile-compaction kernel and gathers the columns; the consume takes the
    sort-grouping route, range-packed where the probe allows, on an empty
    state (``first``).
  * ``entry_distributed(device, n_shards, n_rows, num_keys,
    max_groups_per_shard, seed)``: the group-by of the JAX package's
    ``dryrun_multichip`` (filter -> exchange -> grouped aggregation):
    ``DistContext.group_by`` with the predicate as ``pre_filter`` over
    ``n_shards`` logical shards of ``device``; its step returns the
    ``Table`` with one batch per shard.

With no ``device`` they place the batch on the card
(``arrow_tpu_torch.default_device()``). Run one on the CPU at a small
size::

    python -c "from arrow_tpu_torch.entry import entry_generic as e; \\
        step, args = e('cpu', n_rows=4096); print(step(*args).to_pydict())"
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .compute.expressions import execute_scalar_expression, field
from .core.array import resolve_device
from .core.batch import Batch, Table, batch_from_numpy
from .ops.hash_aggregate import AggregateSpec, HashAggregate
from .ops.selection import filter_batch
from .parallel import DistContext

__all__ = ["AGGREGATES", "AGGREGATES_GENERIC", "MAX_GROUPS",
           "consume_routed", "entry", "entry_distributed", "entry_generic",
           "example_columns", "example_columns_generic"]

AGGREGATES = (AggregateSpec("sum", "v"), AggregateSpec("min", "v"),
              AggregateSpec("sum", "w"), AggregateSpec("min", "w"),
              AggregateSpec("count_all"))
MAX_GROUPS = 2048
AGGREGATES_GENERIC = (AggregateSpec("sum", "v"), AggregateSpec("min", "w"),
                      AggregateSpec("count_all"))


def example_columns(n_rows: int, num_keys: int, seed: int
                    ) -> Dict[str, np.ndarray]:
    """The step's input columns, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, num_keys, n_rows, dtype=np.int64),
            "v": rng.standard_normal(n_rows, dtype=np.float32),
            "w": rng.integers(-100, 100, n_rows, dtype=np.int64)}


def example_columns_generic(n_rows: int, num_keys: int, seed: int
                            ) -> Dict[str, np.ndarray]:
    """``entry_generic``'s input columns, made with numpy from ``seed``:
    int64 ``k`` uniform in [0, num_keys), float64 standard normal ``v``,
    int64 ``w`` uniform in [-100, 100)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, num_keys, n_rows, dtype=np.int64),
            "v": rng.standard_normal(n_rows),
            "w": rng.integers(-100, 100, n_rows, dtype=np.int64)}


def _host_probe(vals: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Fetch the probe scalars with ONE device-to-host copy."""
    names = list(vals)
    flat = torch.cat([vals[k].reshape(-1).to(torch.int64) for k in names])
    host = flat.cpu().numpy()
    out, pos = {}, 0
    for k in names:
        n = vals[k].numel()
        out[k] = host[pos:pos + n].reshape(vals[k].shape)
        pos += n
    return out


def consume_routed(ha: HashAggregate, state, b: Batch,
                   first: bool = False):
    """One batch through the route the JAX AggregateNode picks
    (``acero/nodes.py`` ``_consume_any``): the dense kernel, range-packed
    sort keys or the generic consume; ``first`` (the state is empty) skips
    the table merge-insert of the two sort routes. The sorted dense
    reduction is not ported and raises ``NotImplementedError``."""
    route = ("generic", None)
    if ha.dense_static_ok() or b.capacity >= (1 << 20):
        route = ha.probe_route(b, _host_probe(ha.probe_scalars(b)))
    kind, params = route
    if kind == "dense":
        if params["impl"] != "pallas":
            raise NotImplementedError(
                f"aggregate route 'dense' {params['impl']} is not ported "
                "yet")
        return ha.consume_dense(state, b, params["lo"], params["G"],
                                params["impl"])
    if kind == "packed":
        lo, shift, outmap, K, fold = params
        return ha.consume(state, b, (lo, shift, outmap), (K, fold), first)
    return ha.consume(state, b, None, None, first)


def _make_step(ha: HashAggregate, impl: str, first: bool):
    predicate = field("w") > 0

    def step(batch: Batch) -> Batch:
        mask = execute_scalar_expression(predicate, batch)
        filtered = filter_batch(batch, mask, impl=impl)
        state = consume_routed(ha, ha.init_state(batch.device), filtered,
                               first)
        return ha.finalize(state)

    return step


def entry(device=None, n_rows: int = 1024, num_keys: int = 16,
          seed: int = 0):
    """(step, (batch,)): step(batch) -> the finalized group-by Batch, by
    the compaction-kernel filter and the dense route."""
    b = batch_from_numpy(example_columns(n_rows, num_keys, seed),
                         device=device)
    ha = HashAggregate(b.schema, ["k"], AGGREGATES, max_groups=MAX_GROUPS)
    return _make_step(ha, "dma", False), (b,)


def entry_generic(device=None, n_rows: int = 1024, num_keys: int = 16,
                  seed: int = 0, max_groups: int = 64):
    """(step, (batch,)): step(batch) -> the finalized group-by Batch, by
    the take-index filter and the sort-grouping route on an empty state."""
    b = batch_from_numpy(example_columns_generic(n_rows, num_keys, seed),
                         device=device)
    ha = HashAggregate(b.schema, ["k"], AGGREGATES_GENERIC,
                       max_groups=max_groups)
    return _make_step(ha, "pallas", True), (b,)


def entry_distributed(device=None, n_shards: int = 8, n_rows: int = 1024,
                      num_keys: int = 16, max_groups_per_shard: int = 64,
                      seed: int = 0):
    """(step, (batch,)): step(batch) -> the distributed group-by's Table.
    The mesh is ``n_shards`` logical shards of ``device``; each shard
    filters and pre-aggregates its block of rows, the per-group state rows
    are exchanged by key hash and merged, so every group ends on exactly
    one shard."""
    device = resolve_device(device)
    b = batch_from_numpy(example_columns_generic(n_rows, num_keys, seed),
                         device=device)
    ctx = DistContext(devices=[device] * n_shards)
    predicate = field("w") > 0

    def step(batch: Batch) -> Table:
        return ctx.group_by(batch, ["k"], AGGREGATES_GENERIC,
                            max_groups_per_shard=max_groups_per_shard,
                            pre_filter=predicate)

    return step, (b,)
