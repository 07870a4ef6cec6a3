"""The engine's flagship steps: filter -> group-by on one device and
distributed over a mesh, sort, and hash join.

The entry points return ``(step, args)`` for ``step(*args)``. The one-device ``step``
evaluates the predicate ``w > 0``, filters the batch, routes the grouped
aggregation as the JAX package's ``AggregateNode._consume_any`` does (one
host read of the key range probe, then ``probe_route``), consumes and
finalizes.

  * ``entry(device, n_rows, num_keys, seed, max_groups)``: the schema on
    which the dense route fires (int64 key ``k``, float32 ``v``, int64
    ``w``). The filter is one pass of the stream-compaction kernel and the
    consume one pass of the dense group-by kernel, or, past its 4096 key
    slots, the sorted dense reduction.
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

  * ``entry_sort(device, n_rows, seed, num_keys)``: a two-key sort
    (int64 ``k1`` ascending, int32 ``k2`` with nulls descending, nulls at
    the end) of a batch with a float64 payload: ``sort_indices_batch``,
    then ``take_batch``. Its step returns (indices, sorted batch).
  * ``entry_join(device, n_build, n_probe, seed, join_type, key_dist,
    ...)``: ``HashJoin`` of a probe batch (``k``, ``lv``) against a build
    batch (``k``, ``rv``): ``join_routed`` builds and picks the probe
    ``impl`` from one host read, then probe and finish. Its step returns
    (probe output, finish output or None).

With no ``device`` they place the batch on the card
(``arrow_tpu_torch.default_device()``). Run one on the CPU at a small
size::

    python -c "from arrow_tpu_torch.entry import entry_generic as e; \\
        step, args = e('cpu', n_rows=4096); print(step(*args).to_pydict())"
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .compute.expressions import execute_scalar_expression, field
from .acero.options import HashJoinNodeOptions
from .core.array import array_from_numpy, resolve_device
from .core.batch import Batch, Table, batch, batch_from_numpy
from .ops.bits import SIGNED_OF, unsigned_to_int64
from .ops.hash_aggregate import AggregateSpec, HashAggregate
from .ops.join import BuildState, HashJoin
from .ops.selection import filter_batch, take_batch
from .ops.sorting import SortOptions, sort_indices_batch
from .parallel import DistContext

__all__ = ["AGGREGATES", "AGGREGATES_GENERIC", "MAX_GROUPS", "SORT_KEYS",
           "consume_routed", "entry", "entry_distributed", "entry_generic",
           "entry_join", "entry_sort", "example_columns",
           "example_columns_generic", "example_columns_join",
           "example_columns_sort", "join_routed"]

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
    # as int64: a wide unsigned key's range by its value (uint64: its bits,
    # read back as uint64 on the host)
    flat = torch.cat([
        unsigned_to_int64(vals[k].reshape(-1)) if vals[k].dtype in SIGNED_OF
        else vals[k].reshape(-1).to(torch.int64) for k in names])
    host = flat.cpu().numpy()
    out, pos = {}, 0
    for k in names:
        n = vals[k].numel()
        piece = host[pos:pos + n]
        if vals[k].dtype == torch.uint64:
            piece = piece.view(np.uint64)
        out[k] = piece.reshape(vals[k].shape)
        pos += n
    return out


def consume_routed(ha: HashAggregate, state, b: Batch,
                   first: bool = False):
    """One batch through the route the JAX AggregateNode picks
    (``acero/nodes.py`` ``_consume_any``): the dense kernel, the sorted
    dense reduction past its slot count, range-packed sort keys or the
    generic consume; ``first`` (the state is empty) skips the table
    merge-insert of the two sort routes."""
    route = ("generic", None)
    if ha.dense_static_ok() or b.capacity >= (1 << 20):
        route = ha.probe_route(b, _host_probe(ha.probe_scalars(b)))
    kind, params = route
    if kind == "dense":
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
          seed: int = 0, max_groups: int = MAX_GROUPS):
    """(step, (batch,)): step(batch) -> the finalized group-by Batch, by
    the compaction-kernel filter and the dense route: the dense kernel up
    to 4096 key slots, the sorted dense reduction past them (``max_groups``
    must hold the key domain for either)."""
    b = batch_from_numpy(example_columns(n_rows, num_keys, seed),
                         device=device)
    ha = HashAggregate(b.schema, ["k"], AGGREGATES, max_groups=max_groups)
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


# ---- sort ------------------------------------------------------------------

SORT_KEYS = (("k1", "ascending"), ("k2", "descending"))


def example_columns_sort(n_rows: int, num_keys: int, seed: int
                         ) -> Dict[str, np.ndarray]:
    """``entry_sort``'s input, made with numpy from ``seed``: int64 ``k1``
    uniform in [0, num_keys), int32 ``k2`` uniform over all int32 with its
    validity ``k2_valid`` (5 % nulls), float64 standard normal ``v``."""
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, num_keys, n_rows, dtype=np.int64),
            "k2": rng.integers(-(1 << 31), 1 << 31, n_rows, dtype=np.int32),
            "k2_valid": rng.random(n_rows, dtype=np.float32) >= 0.05,
            "v": rng.standard_normal(n_rows)}


def entry_sort(device=None, n_rows: int = 1024, seed: int = 0,
               num_keys: int = 64):
    """(step, (batch,)): step(batch) -> (indices, sorted batch): the stable
    sort permutation of ``SORT_KEYS`` with nulls at the end, and the batch
    taken through it."""
    cols = example_columns_sort(n_rows, num_keys, seed)
    b = batch({"k1": array_from_numpy(cols["k1"], device=device),
               "k2": array_from_numpy(cols["k2"], validity=cols["k2_valid"],
                                      device=device),
               "v": array_from_numpy(cols["v"], device=device)})
    options = SortOptions(SORT_KEYS, "at_end")

    def step(batch_: Batch):
        indices = sort_indices_batch(batch_, options)
        return indices, take_batch(batch_, indices)

    return step, (b,)


# ---- join ------------------------------------------------------------------

def join_routed(hj: HashJoin, build_batch: Batch):
    """(BuildState, probe impl): build, then ONE host read of (error,
    pack_bits, num_groups, num_active) picks the probe route as the JAX
    package's ``HashJoinNode._build_recover`` does: "packed_u" for unique
    build keys that pack into 30 bits, "packed" for packable keys with
    duplicates, else "sort". A set error flag (more distinct keys than
    ``max_build_rows``) raises: rebuilding at a doubled capacity is the
    plan node's business (ROADMAP queue item A7)."""
    bs: BuildState = hj.build(build_batch)
    err, bits, ng, na = (int(x) for x in torch.stack(
        [bs.error, bs.pack_bits, bs.num_groups, bs.num_active]).cpu())
    if err:
        raise RuntimeError(
            f"hash join build: more than max_build_rows="
            f"{hj.max_build_rows} distinct keys")
    if bits <= 30 and hj.packed_eligible() and \
            build_batch.capacity < (1 << 26):
        impl = "packed_u" if (ng == na and hj.supports_unique_fast()) \
            else "packed"
    else:
        impl = "sort"
    return bs, impl


def example_columns_join(n_build: int, n_probe: int, seed: int,
                         key_dist: str = "uniform",
                         build_keys: Optional[int] = None,
                         wide: bool = False):
    """(build columns, probe columns) of ``entry_join``, made with numpy
    from ``seed``. Build: ``n_build`` rows over ``build_keys`` distinct int64
    keys ``k`` (default ``n_build``: a permutation of 0 .. n_build - 1, each
    once), float64 ``rv``. Probe: int64 ``k`` uniform in [0, 4 x
    build_keys) for "uniform" (a quarter of the rows match), or a build
    key whose rank is Zipf(1.5)-distributed for "zipf" (every row matches;
    the first ranks take most of the rows); float32 ``lv``. ``wide`` adds a
    second key ``k2`` = ``k`` times a 62-bit odd constant mod 2^64, which
    no 30-bit window holds."""
    rng = np.random.default_rng(seed)
    nk = build_keys or n_build
    bk = rng.permutation(nk).astype(np.int64)
    if n_build > nk:
        bk = np.concatenate([bk, rng.integers(0, nk, n_build - nk,
                                              dtype=np.int64)])
    build = {"k": bk, "rv": rng.standard_normal(n_build)}
    if key_dist == "uniform":
        pk = rng.integers(0, 4 * nk, n_probe, dtype=np.int64)
    elif key_dist == "zipf":
        pk = bk[(rng.zipf(1.5, n_probe) - 1) % nk]
    else:
        raise ValueError(f"key_dist {key_dist!r}: 'uniform' or 'zipf'")
    probe = {"k": pk, "lv": rng.standard_normal(n_probe, dtype=np.float32)}
    if wide:
        c = np.int64(0x2545F4914F6CDD1D)
        with np.errstate(over="ignore"):
            build = {"k": bk, "k2": bk * c, "rv": build["rv"]}
            probe = {"k": pk, "k2": pk * c, "lv": probe["lv"]}
    return build, probe


def entry_join(device=None, n_build: int = 256, n_probe: int = 1024,
               seed: int = 0, join_type: str = "inner",
               key_dist: str = "uniform", build_keys: Optional[int] = None,
               wide: bool = False, fanout_capacity: Optional[int] = None):
    """(step, (build batch, probe batch)): step -> (probe output, finish
    output or None). Output columns: the probe side's keys and ``lv``, the
    build side's ``rv``. Raises if a capacity was exceeded (the build's in
    ``join_routed``, the fanout's after the probe: one more host read)."""
    bcols, pcols = example_columns_join(n_build, n_probe, seed, key_dist,
                                        build_keys, wide)
    bb = batch_from_numpy(bcols, device=device)
    pb = batch_from_numpy(pcols, device=device)
    keys = ["k", "k2"] if wide else ["k"]
    hj = HashJoin(pb.schema, bb.schema, HashJoinNodeOptions(
        join_type, left_keys=keys, right_keys=keys,
        left_output=keys + ["lv"], right_output=["rv"],
        max_build_rows=n_build, fanout_capacity=fanout_capacity))

    def step(build_batch: Batch, probe_batch: Batch):
        bs, impl = join_routed(hj, build_batch)
        out, bs = hj.probe(bs, probe_batch, impl=impl)
        tail = hj.finish(bs)
        if int(bs.error):
            raise RuntimeError(
                "hash join probe: more output rows than fanout_capacity")
        return out, tail

    step.join = hj
    return step, (bb, pb)
