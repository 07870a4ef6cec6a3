"""The engine's flagship steps: filter -> group-by on one device and
distributed over a mesh, sort, hash join, and the Q3-shaped plan.

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
  * ``entry_q3(device, n_lineitem, seed, max_groups, max_batch_rows)``:
    the Q3-shaped Declaration of the JAX package's dry run (filter ->
    hashjoin -> hashjoin -> project -> aggregate -> order_by -> fetch)
    over multi-batch lineitem / orders / customer Tables, run by
    ``Declaration.to_table``. Its step returns the Table of the top 10.
  * ``entry_q3_dist(device, n_shards, n_lineitem, seed, max_groups,
    max_batch_rows)``: the same Declaration with ``dist=`` a context of
    ``n_shards`` logical shards of ``device`` on both joins and the
    aggregate, as the JAX package's dry run writes it.
  * ``entry_dist_join(device, n_shards, n_build, n_probe, seed,
    join_type)``: ``DistContext.join`` of ``entry_join``'s columns; its
    step returns the Table, one batch per shard.
  * ``entry_dist_sort(device, n_shards, n_rows, seed, num_keys,
    bucket_factor)``: ``DistContext.sort_by`` of ``entry_sort``'s batch by
    ``SORT_KEYS``, nulls at the end; its step returns the Table, one
    batch per shard in key-range order.
  * ``dryrun_multichip(n_shards, device)``: the five checks of the JAX
    package's ``dryrun_multichip`` (group-by, join, sort, one hot key, the
    Q3 Declaration with ``dist=``) on ``n_shards`` logical shards.

String and dictionary columns:

  * ``entry_sort_dict(device, n_rows, seed, num_values)``: BASELINE #3's
    sort (the JAX package's ``bench.py`` config 3): int64 ``i``, a
    dictionary<int32, utf8> ``s`` over the values ``cat%04d`` with 5 %
    null rows, float64 ``v``, sorted by ``s`` ascending then ``i``
    descending, nulls at the end. Its step returns (indices, sorted
    batch).
  * ``entry_q3s(device, n_lineitem, seed, max_groups, max_batch_rows)``:
    ``entry_q3`` with customer's segment as TPC-H's ``c_mktsegment``, a
    dictionary of the five segment names, filtered by ``== "BUILDING"``.
  * ``entry_strings(device, n_rows, num_keys, seed, max_groups)``: the
    filter -> group-by step of ``entry_generic`` keyed by a raw string
    column ``name`` of TPC-H's ``C_NAME`` form ``Customer#%09d`` (18
    bytes) over ``num_keys`` customer keys.
  * ``entry_q3_dist(..., segment="BUILDING")``: ``entry_q3s``'s
    tables and filter with ``dist=`` over the mesh.
  * ``entry_dist_dict(device, n_shards, n_rows, num_keys,
    max_groups_per_shard, seed)``: ``entry_distributed`` keyed by
    ``name``, a dictionary<int32, utf8> of TPC-H ``C_NAME`` values.
  * ``entry_dist_sort_dict(device, n_shards, n_rows, seed, num_keys,
    num_values, bucket_factor)``: ``entry_dist_sort`` with the dictionary
    string ``s`` (``cat%04d``, 5 % nulls) descending in ``k2``'s place.

The other aggregators:

  * ``entry_any_all(device, n_rows, num_keys, seed, max_groups)``:
    ``entry``'s step with count_all, sum(v), min(w), any(f) and all(f)
    over a bool ``f`` with 5 % nulls (False for keys = 1 mod 4, True for
    keys = 0 mod 4): the dense kernel's ``any8`` / ``all8`` kinds.
  * ``entry_groupby_q6(device, n_rows, seed, k)``: db-benchmark's groupby
    q6 ("median v3 sd v3 by id4 id5") on its nine-column table
    ``G1_<n_rows>_<k>_0_0`` through ``Table.group_by``; the step returns
    the Table of k^2 groups.
  * ``entry_dist_groupby_q6(device, n_shards, n_rows, seed, k,
    bucket_factor)``: q6 over ``n_shards`` logical shards through
    ``DistContext.group_by`` (the raw-row shuffle: the median's state is
    not row-shaped).

The string family:

  * ``entry_q13(device, scale_factor, seed, max_groups, max_batch_rows,
    source)``: TPC-H Q13 (``q13_declaration``) over the port's TPC-H
    tables (``utils/tpch.py``), the orders filtered by the regex
    ``special.*requests`` at the host hop; its step returns the Table
    (c_count, custdist), ``q13_pyarrow`` its oracle.
  * ``entry_q22(device, scale_factor, seed, max_batch_rows, source)``:
    TPC-H Q22 (``q22_declarations``: a scalar average read once, then a
    left anti join and a group-by on the 2-byte country code made by
    ``utf8_slice_codeunits`` on the device); ``q22_pyarrow`` its oracle.
  * ``entry_host_boundary(device, n_rows, seed, staging)``: bench.py's
    host_boundary step (``match_substring_regex`` then ``filter_batch``)
    with ``s`` a dictionary or a plain string column;
    ``host_boundary_numpy`` its oracle.
  * ``STRING_SWEEP``, ``sweep_column``, ``sweep_call``: the family's 71
    functions with their unit tests' options, over a column of strings
    with non-ASCII rows.

Casts, temporal functions, checked arithmetic, vector_misc and set lookup:

  * ``entry_q12(device, scale_factor, seed, max_batch_rows, source)``:
    TPC-H Q12 (``q12_declaration``: ``is_in`` on the ship-mode
    dictionary, date32 ranges, the join to orders, its CASE as a cast of
    ``is_in``); ``q12_pyarrow`` its oracle.
  * ``entry_q7(device, scale_factor, seed, max_batch_rows, source)``:
    TPC-H Q7 (``q7_declaration``: ``is_in`` on each nation side, five
    joins, ``year(l_shipdate)`` on the device); ``q7_pyarrow`` its
    oracle.
  * ``A7B_SWEEP``, ``a7b_sweep_columns``, ``a7b_sweep_call``: the 83
    functions of those five modules, and every pair of types ``cast``
    dispatches, over columns made from a seed.

Nested layouts (lists, structs, unions, run-end encoding, pivot, tensors):

  * ``entry_wordcount(device, scale_factor, seed, max_batch_rows,
    max_groups, source)``: HiBench's WordCount over TPC-H's
    ``o_comment`` (``wordcount_words``: ``utf8_split_whitespace``, then
    ``list_flatten``; ``wordcount_declaration``: the count by word,
    ordered by count then word); ``wordcount_pyarrow`` its oracle.
  * ``entry_baskets(device, scale_factor, seed, max_batch_rows,
    source)``: order baskets of lineitem (``baskets_declaration``:
    ``hash_list`` and ``hash_pivot_wider`` by ``l_orderkey``, the list
    and struct functions, a filter of the list and struct columns);
    ``baskets_numpy`` its oracle, ``baskets_arrays`` / ``baskets_differ``
    the comparison.
  * ``entry_ree_keys(device, scale_factor, seed, max_batch_rows,
    source)``: each batch of the sorted ``l_orderkey`` run-end encoded
    and decoded; ``ree_runs_numpy`` the run ends.
  * ``A7C_SWEEP``, ``a7c_sweep_columns``, ``nested_parts``: the 19
    functions, take / filter / concat of each nested layout, the grouped
    aggregators, pivot_longer and the sparse tensors over columns made
    from a seed.

The out-of-core and dataset layer (``dataset``, ``acero/spill``):

  * ``entry_scan_q12(device, scale_factor, seed, max_batch_rows,
    source)``: TPC-H Q12 with ``scan`` sources over lineitem written as a
    hive-partitioned parquet dataset by ``l_shipmode`` (the ship-mode
    ``IN`` prunes files on the host) and orders as one file.
  * ``entry_disk_sort(device, scale_factor, seed, max_batch_rows,
    source)``: the external sort of lineitem's ``DISK_SORT`` columns past
    a budget of 1/``DISK_SORT_SPILL_FRACTION`` of their bytes, read
    through ``to_batches_prefetched``; ``disk_sort_order`` /
    ``disk_sort_differ`` its oracle, ``same_rows`` the comparison with
    the in-memory sort.
  * ``entry_partitioned_join(device, scale_factor, seed, max_batch_rows,
    source)``: the Grace join of orders and lineitem past a budget of
    1/``PJOIN_SPILL_FRACTION`` of the orders' bytes;
    ``pjoin_slices`` a tenth of each with rows that match nothing,
    ``tables_differ`` the comparison with the in-memory join.

With no ``device`` they place the batch on the card
(``arrow_tpu_torch.default_device()``). Run one on the CPU at a small
size::

    python -c "from arrow_tpu_torch.entry import entry_generic as e; \\
        step, args = e('cpu', n_rows=4096); print(step(*args).to_pydict())"

and the multi-shard dry run on 8 logical CPU shards::

    python -c "from arrow_tpu_torch.entry import dryrun_multichip as d; \\
        d(8, 'cpu')"
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .compute.expressions import execute_scalar_expression, field
from .acero.nodes import (  # noqa: F401 (_host_probe: re-exported)
    _host_probe, build_and_route, consume_routed)
from .acero.options import HashJoinNodeOptions
from .core.array import Array, array_from_numpy, dictionary_from_numpy, \
    resolve_device, varlen_from_numpy
from .core.batch import Batch, Table, batch, batch_from_numpy
from .ops.hash_aggregate import AggregateSpec, HashAggregate
from .ops.join import HashJoin
from .ops.selection import filter_batch, take_batch
from .ops.sorting import SortOptions, sort_indices_batch
from .parallel import DistContext

__all__ = ["AGGREGATES", "AGGREGATES_ANY_ALL", "AGGREGATES_GENERIC",
           "MAX_GROUPS", "Q6_KEYS", "SEGMENTS",
           "SORT_KEYS", "SORT_KEYS_DICT", "SORT_KEYS_DIST_DICT",
           "consume_routed", "entry", "entry_any_all", "entry_distributed",
           "entry_dist_groupby_q6", "entry_generic", "entry_groupby_q6",
           "example_columns_any_all", "example_columns_q6", "q6_aggregates",
           "dryrun_multichip", "entry_dist_dict", "entry_dist_join",
           "entry_dist_sort", "entry_dist_sort_dict", "entry_join",
           "entry_q3", "entry_q3_dist", "entry_q3s", "entry_sort",
           "entry_sort_dict", "entry_strings", "example_columns",
           "example_columns_generic", "example_columns_join",
           "example_columns_q3", "example_columns_sort",
           "example_columns_sort_dict", "example_columns_sort_dist_dict",
           "example_columns_strings", "join_routed", "numbered_strings",
           "q3_declaration", "table_from_numpy", "HB_PATTERN", "HB_WORDS",
           "Q13_PATTERN", "Q22_CODES", "entry_host_boundary", "entry_q13",
           "entry_q22", "example_columns_host_boundary", "host_boundary_numpy",
           "q13_declaration", "q13_pyarrow", "q22_declarations",
           "q22_pyarrow", "tpch_tables", "STRING_SWEEP", "SWEEP_NON_ASCII",
           "sweep_call", "sweep_column", "Q12_COLUMNS", "Q7_COLUMNS",
           "Q12_MODES", "Q12_PRIORITIES", "Q7_NATIONS", "entry_q12",
           "entry_q7", "q12_declaration", "q7_declaration", "q12_pyarrow",
           "q7_pyarrow", "A7B_SWEEP", "A7B_NUMERIC", "A7B_TEMPORAL",
           "A7B_ZONES", "a7b_sweep_call", "a7b_sweep_columns",
           "BASKETS_COLUMNS", "BASKET_LINES", "BASKET_MIN_PARTS",
           "WORDCOUNT_COLUMNS", "baskets_arrays", "baskets_declaration",
           "baskets_differ", "baskets_numpy", "entry_baskets",
           "entry_ree_keys", "entry_wordcount", "ree_runs_numpy",
           "wordcount_declaration", "wordcount_pyarrow", "wordcount_words",
           "A7C_SWEEP", "a7c_product_scale", "a7c_sweep_columns",
           "nested_parts", "ASOF_QUOTE_GAP", "ASOF_SYMBOLS",
           "DECIMAL_COLUMNS", "DECIMAL_Q1_COLUMNS", "DECIMAL_WIDE",
           "Q1_COLUMNS", "SMERGE_COLUMNS", "SMERGE_KEYS", "asof_declaration",
           "asof_differ", "asof_numpy", "decimal_ints", "decimal_lineitem",
           "decimal_q1_declarations", "decimal_q1_differ",
           "decimal_q1_numpy", "discount_counts_declaration", "entry_asof",
           "entry_decimal_q1", "entry_sorted_merge", "entry_tpch_gen_q1",
           "example_columns_asof", "q1_differ", "q1_numpy",
           "sorted_merge_differ", "tpch_gen_q1_declaration", "DIST_CASES",
           "dist_case_tables", "dist_worker", "launch_dist_workers",
           "table_host_arrays", "DISK_SORT_COLUMNS", "DISK_SORT_KEYS",
           "PJOIN_COLUMNS", "disk_sort_differ", "disk_sort_order",
           "entry_disk_sort", "same_rows",
           "entry_partitioned_join", "entry_scan_q12", "pjoin_slices",
           "q12_filter", "sorted_columns", "tables_differ",
           "AVRO_ORDERS_COLUMNS", "PLAN_DRIVERS", "avro_orders_declaration",
           "avro_orders_numpy", "entry_avro_scan", "entry_fused_q3",
           "entry_substrait_q3", "plan_driver", "write_avro_orders"]

AGGREGATES = (AggregateSpec("sum", "v"), AggregateSpec("min", "v"),
              AggregateSpec("sum", "w"), AggregateSpec("min", "w"),
              AggregateSpec("count_all"))
MAX_GROUPS = 2048
AGGREGATES_GENERIC = (AggregateSpec("sum", "v"), AggregateSpec("min", "w"),
                      AggregateSpec("count_all"))


def numbered_strings(prefix: bytes, keys: np.ndarray, digits: int):
    """(offsets, pool) of the strings ``prefix + "%0{digits}d" % key`` for
    each non-negative key, built with digit arithmetic on an (n, width)
    uint8 matrix (no per-row Python strings): TPC-H's ``C_NAME`` is
    ``numbered_strings(b"Customer#", custkey, 9)``."""
    keys = np.asarray(keys, dtype=np.int64)
    n = keys.shape[0]
    width = len(prefix) + digits
    mat = np.empty((n, width), dtype=np.uint8)
    mat[:, :len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    rest = keys.copy()
    for j in range(width - 1, len(prefix) - 1, -1):
        mat[:, j] = 48 + rest % 10
        rest //= 10
    return np.arange(n + 1, dtype=np.int64) * width, mat.reshape(-1)


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
                      seed: int = 0, ctx: Optional[DistContext] = None):
    """(step, (batch,)): step(batch) -> the distributed group-by's Table.
    The mesh is ``n_shards`` logical shards of ``device``, or ``ctx``'s
    (across processes too: every process stages the same global batch on
    its first shard's device and keeps its shards of it); each shard
    filters and pre-aggregates its block of rows, the per-group state rows
    are exchanged by key hash and merged, so every group ends on exactly
    one shard."""
    device = resolve_device(device) if ctx is None else ctx.devices[0]
    b = batch_from_numpy(example_columns_generic(n_rows, num_keys, seed),
                         device=device)
    if ctx is None:
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


SORT_KEYS_DICT = (("s", "ascending"), ("i", "descending"))


def example_columns_sort_dict(n_rows: int, seed: int,
                              num_values: int = 1000
                              ) -> Dict[str, np.ndarray]:
    """``entry_sort_dict``'s columns, made with numpy from ``seed``: int64
    ``i`` uniform in [-2^40, 2^40); ``s_idx`` int32 uniform in [0,
    num_values) with ``s_valid`` False for 5 % of the rows (indices into
    the values ``cat%04d``, in their order); float64 standard normal
    ``v``."""
    rng = np.random.default_rng(seed)
    return {"i": rng.integers(-(1 << 40), 1 << 40, n_rows, dtype=np.int64),
            "s_idx": rng.integers(0, num_values, n_rows, dtype=np.int32),
            "s_valid": rng.random(n_rows) >= 0.05,
            "v": rng.standard_normal(n_rows)}


def _cat_column(cols, num_values: int, device):
    """The dictionary<int32, utf8> column of ``cols["s_idx"]`` (validity
    ``cols["s_valid"]``) into the values ``cat%04d`` in their order."""
    off, pool = numbered_strings(b"cat", np.arange(num_values), 4)
    vocab = varlen_from_numpy(offsets=off, pool=pool, device=device)
    return dictionary_from_numpy(cols["s_idx"], vocab,
                                 validity=cols["s_valid"], device=device)


def entry_sort_dict(device=None, n_rows: int = 1024, seed: int = 0,
                    num_values: int = 1000):
    """(step, (batch,)): step(batch) -> (indices, sorted batch) by
    ``SORT_KEYS_DICT`` with nulls at the end: BASELINE #3's sort on its
    (dictionary-encoded string, int64) keys."""
    cols = example_columns_sort_dict(n_rows, seed, num_values)
    b = batch({"i": array_from_numpy(cols["i"], device=device),
               "s": _cat_column(cols, num_values, device),
               "v": array_from_numpy(cols["v"], device=device)})
    options = SortOptions(SORT_KEYS_DICT, "at_end")

    def step(batch_: Batch):
        indices = sort_indices_batch(batch_, options)
        return indices, take_batch(batch_, indices)

    return step, (b,)


# ---- join ------------------------------------------------------------------

def join_routed(hj: HashJoin, build_batch: Batch):
    """(BuildState, probe impl): ``acero.nodes.build_and_route``, the
    plan node's build and route from one host read. A set error flag (more
    distinct keys than ``max_build_rows``) raises here; the plan node
    rebuilds at a doubled capacity instead."""
    bs, err, impl = build_and_route(hj, build_batch)
    if err:
        raise RuntimeError(
            f"hash join build: more than max_build_rows="
            f"{hj.max_build_rows} distinct keys")
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


# ---- the Q3-shaped plan ----------------------------------------------------

def example_columns_q3(n_lineitem: int, seed: int):
    """(lineitem, orders, customer) columns of ``entry_q3``, made with numpy
    from ``seed`` in the shapes and distributions of the JAX package's Q3
    dry run (``__graft_entry__.py``): no = n_lineitem / 4 orders and nc =
    no / 10 customers (TPC-H's lineitem : orders : customer ratio).
    lineitem: ``l_orderkey`` int64 uniform in [0, no), ``l_price`` float32
    U * 100, ``l_disc`` float32 U * 0.1, ``l_ship`` int32 in [0, 100);
    orders: ``o_orderkey`` = 0 .. no - 1, ``o_custkey`` int64 uniform in [0,
    nc), ``o_date`` int32 in [0, 50); customer: ``c_custkey`` = 0 .. nc - 1,
    ``c_seg`` int32 in [0, 3)."""
    rng = np.random.default_rng(seed)
    nl = n_lineitem
    no = max(nl // 4, 1)
    nc = max(no // 10, 1)
    li = {"l_orderkey": rng.integers(0, no, nl, dtype=np.int64),
          "l_price": rng.random(nl, dtype=np.float32) * np.float32(100),
          "l_disc": rng.random(nl, dtype=np.float32) * np.float32(0.1),
          "l_ship": rng.integers(0, 100, nl, dtype=np.int32)}
    od = {"o_orderkey": np.arange(no, dtype=np.int64),
          "o_custkey": rng.integers(0, nc, no, dtype=np.int64),
          "o_date": rng.integers(0, 50, no, dtype=np.int32)}
    cu = {"c_custkey": np.arange(nc, dtype=np.int64),
          "c_seg": rng.integers(0, 3, nc, dtype=np.int32)}
    return li, od, cu


def table_from_numpy(cols: Dict[str, np.ndarray], max_batch_rows: int,
                     device=None, dictionaries=None) -> Table:
    """A Table of ``batch_from_numpy`` slices of at most ``max_batch_rows``
    rows (no pyarrow). ``dictionaries`` maps a column name to the numpy
    values of a dictionary: that column holds indices into it, and every
    batch shares the one dictionary."""
    n = len(next(iter(cols.values())))
    dicts = {k: array_from_numpy(np.asarray(v), device=device)
             for k, v in (dictionaries or {}).items()}

    def column(k, v):
        if k in dicts:
            return dictionary_from_numpy(v, dicts[k], device=device)
        return v
    batches = [batch_from_numpy({k: column(k, v[s:s + max_batch_rows])
                                 for k, v in cols.items()}, device=device)
               for s in range(0, max(n, 1), max_batch_rows)]
    return Table(batches[0].schema, batches)


def q3_declaration(li, od, cu, max_groups: int = 256, dist=None,
                   segment=None, fanout_capacity: Optional[int] = None):
    """The Q3-shaped Declaration of the JAX package's dry run
    (``__graft_entry__.py``, BASELINE config #5) over the tables ``li``,
    ``od``, ``cu``, on one device, or with ``dist`` (a ``DistContext``) on
    both joins and the aggregate over its mesh: table_source -> filter (l_ship > 40) ->
    hashjoin on l_orderkey against (orders with o_date < 25) hashjoin on
    o_custkey (customers with c_seg == 1) -> project rev = l_price * (1.0 -
    l_disc) -> aggregate sum(rev) by (l_orderkey, o_date) -> order_by
    (revenue desc, l_orderkey asc) -> fetch 10. The joins' build capacities
    are the orders' and customers' row counts (at least 16). With
    ``segment`` (a string, as ``entry_q3s`` passes), the customers are
    filtered by TPC-H's ``c_mktsegment == segment`` instead of
    ``c_seg == 1``. ``fanout_capacity`` is the lineitem join's (with
    ``dist``: a shard's)."""
    from .acero import (AggregateNodeOptions, Declaration, FetchNodeOptions,
                        FilterNodeOptions, OrderByNodeOptions,
                        ProjectNodeOptions, TableSourceNodeOptions)
    from .compute.expressions import literal
    no, nc = od.num_rows, cu.num_rows
    co = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        left_output=["o_orderkey", "o_date"], right_output=[],
        max_build_rows=max(nc, 16), dist=dist),
        inputs=[
            Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(od)),
                Declaration("filter", FilterNodeOptions(
                    field("o_date") < literal(25)))]),
            Declaration.from_sequence([
                Declaration("table_source", TableSourceNodeOptions(cu)),
                Declaration("filter", FilterNodeOptions(
                    field("c_seg") == literal(1) if segment is None
                    else field("c_mktsegment") == segment))]),
        ])
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_orderkey", "l_price", "l_disc"],
            right_output=["o_date"], max_build_rows=max(no, 16),
            fanout_capacity=fanout_capacity, dist=dist),
            inputs=[
                Declaration.from_sequence([
                    Declaration("table_source", TableSourceNodeOptions(li)),
                    Declaration("filter", FilterNodeOptions(
                        field("l_ship") > literal(40)))]),
                co]),
        Declaration("project", ProjectNodeOptions(
            [field("l_orderkey"),
             field("l_price") * (literal(1.0) - field("l_disc")),
             field("o_date")],
            ["l_orderkey", "rev", "o_date"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "rev", name="revenue")],
            keys=["l_orderkey", "o_date"], max_groups=max_groups,
            dist=dist)),
        Declaration("order_by", OrderByNodeOptions(
            [("revenue", "descending"), ("l_orderkey", "ascending")])),
        Declaration("fetch", FetchNodeOptions(0, 10)),
    ])


def _q3_tables(device=None, n_lineitem: int = 768, seed: int = 0,
              max_batch_rows: int = 64, segment: bool = False):
    """The Tables (lineitem, orders, customer) of ``max_batch_rows``-row
    batches of ``example_columns_q3``; with ``segment``, customer's
    ``c_seg`` codes become ``c_mktsegment``, a dictionary<int32, utf8>
    over ``SEGMENTS`` whose indices they are (``BUILDING`` is index 1)."""
    li, od, cu = example_columns_q3(n_lineitem, seed)
    dicts = None
    if segment:
        cu = {"c_custkey": cu["c_custkey"], "c_mktsegment": cu["c_seg"]}
        dicts = {"c_mktsegment": np.array(SEGMENTS)}
    return (table_from_numpy(li, max_batch_rows, device),
            table_from_numpy(od, max_batch_rows, device),
            table_from_numpy(cu, max_batch_rows, device, dicts))


def entry_q3(device=None, n_lineitem: int = 768, seed: int = 0,
             max_groups: int = 256, max_batch_rows: int = 64):
    """(step, (lineitem, orders, customer)): step(li, od, cu) -> the Table
    of ``q3_declaration`` run by ``Declaration.to_table``: the 10 orders of
    most revenue (``l_orderkey``, ``o_date``, ``revenue`` float64). The
    inputs are Tables of ``max_batch_rows``-row batches of
    ``example_columns_q3``; the defaults are the dry run's (96 x 8 lineitem
    rows in 64-row batches, 256 groups, which the aggregate outgrows and
    doubles)."""
    tables = _q3_tables(device, n_lineitem, seed, max_batch_rows)

    def step(li_: Table, od_: Table, cu_: Table) -> Table:
        return q3_declaration(li_, od_, cu_, max_groups).to_table()

    return step, tables


# TPC-H's market segments in the JAX package's order (``utils/tpch.py``)
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")


def entry_q3s(device=None, n_lineitem: int = 768, seed: int = 0,
              max_groups: int = 256, max_batch_rows: int = 64):
    """``entry_q3`` with the customer segment as TPC-H has it:
    ``c_mktsegment``, a dictionary<int32, utf8> over ``SEGMENTS`` whose
    indices are ``entry_q3``'s ``c_seg`` codes (``BUILDING`` is index 1),
    filtered by ``c_mktsegment == "BUILDING"``: the same rows as
    ``entry_q3``'s ``c_seg == 1``, so the same answer."""
    tables = _q3_tables(device, n_lineitem, seed, max_batch_rows, True)

    def step(li_: Table, od_: Table, cu_: Table) -> Table:
        return q3_declaration(li_, od_, cu_, max_groups,
                              segment="BUILDING").to_table()

    return step, tables


def example_columns_strings(n_rows: int, num_keys: int, seed: int
                            ) -> Dict[str, np.ndarray]:
    """``entry_strings``'s columns, made with numpy from ``seed``: int64
    ``custkey`` uniform in [1, num_keys] (the key the names encode),
    float64 standard normal ``v``, int64 ``w`` uniform in [-100, 100)."""
    rng = np.random.default_rng(seed)
    return {"custkey": rng.integers(1, num_keys + 1, n_rows, dtype=np.int64),
            "v": rng.standard_normal(n_rows),
            "w": rng.integers(-100, 100, n_rows, dtype=np.int64)}


def entry_strings(device=None, n_rows: int = 1024, num_keys: int = 100,
                  seed: int = 0, max_groups: int = 1 << 21):
    """(step, (batch,)): ``entry_generic``'s step (``w > 0``, one-launch
    filter, sum(v), min(w), count_all) grouped by ``name``, the raw string
    ``Customer#%09d`` of each row's custkey (TPC-H's C_NAME, 18 bytes: the
    fingerprint form of the content lanes)."""
    cols = example_columns_strings(n_rows, num_keys, seed)
    off, pool = numbered_strings(b"Customer#", cols["custkey"], 9)
    b = batch({"name": varlen_from_numpy(offsets=off, pool=pool,
                                         device=device),
               "v": array_from_numpy(cols["v"], device=device),
               "w": array_from_numpy(cols["w"], device=device)})
    ha = HashAggregate(b.schema, ["name"], AGGREGATES_GENERIC, max_groups)
    return _make_step(ha, "dma", True), (b,)


# ---- the string functions: TPC-H Q13 and Q22, bench.py's host_boundary ------

Q13_PATTERN = "special.*requests"
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")
HB_PATTERN = r"7x[12]?[0-9]$"


def tpch_tables(scale_factor: float, seed: int, columns: Dict[str, list],
                max_batch_rows: int = 1 << 22, device=None, source=None):
    """TPC-H tables of the port's generator (``utils/tpch.py``, pyarrow
    imported there), or of ``source`` (pyarrow tables by name), each with
    only the ``columns`` a query reads, as a scan's projection stages
    them: (the pyarrow tables, the same staged on ``device`` in batches of
    ``max_batch_rows`` rows)."""
    from .utils.tpch import tpch_table
    source = {name: (source[name].select(cols) if source else
                     tpch_table(name, scale_factor, seed, columns=cols))
              for name, cols in columns.items()}
    return source, {name: Table.from_pyarrow(
        t, max_rows_per_batch=max_batch_rows, device=device)
        for name, t in source.items()}


Q13_COLUMNS = {"customer": ["c_custkey"],
               "orders": ["o_orderkey", "o_custkey", "o_comment"]}
Q22_COLUMNS = {"customer": ["c_custkey", "c_phone", "c_acctbal"],
               "orders": ["o_custkey"]}


def q13_declaration(customer: Table, orders: Table,
                    max_groups: int = 1 << 21):
    """TPC-H Q13 (clause 2.4.13) as a Declaration: orders filtered by
    ``o_comment NOT LIKE '%special%requests%'`` (the regex
    ``special.*requests`` through the host hop) -> customer left outer
    join orders on c_custkey = o_custkey -> count(o_orderkey) by
    c_custkey as c_count -> count_all by c_count as custdist -> order by
    custdist desc, c_count desc."""
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, OrderByNodeOptions,
                        TableSourceNodeOptions)
    from .compute.expressions import call
    from .ops.strings import MatchSubstringOptions
    special = call("match_substring_regex", [field("o_comment")],
                   MatchSubstringOptions(Q13_PATTERN))
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "left outer", left_keys=["c_custkey"], right_keys=["o_custkey"],
            left_output=["c_custkey"], right_output=["o_orderkey"],
            max_build_rows=max(orders.num_rows, 16)),
            inputs=[
                Declaration("table_source", TableSourceNodeOptions(customer)),
                Declaration.from_sequence([
                    Declaration("table_source",
                                TableSourceNodeOptions(orders)),
                    Declaration("filter", FilterNodeOptions(~special))])]),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("count", "o_orderkey", name="c_count")],
            keys=["c_custkey"], max_groups=max_groups)),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("count_all", name="custdist")],
            keys=["c_count"], max_groups=256)),
        Declaration("order_by", OrderByNodeOptions(
            [("custdist", "descending"), ("c_count", "descending")])),
    ])


def _q22_customers(customer: Table, balance):
    """Q22's customers: cntrycode = the first two codepoints of c_phone
    (on the device), kept where c_acctbal > ``balance`` and the code is in
    ``Q22_CODES`` (one ``is_in``, as TPC-H writes it)."""
    from .acero import (Declaration, FilterNodeOptions, ProjectNodeOptions,
                        TableSourceNodeOptions)
    from .compute.expressions import call, literal
    from .ops.strings import SliceOptions
    in_set = field("cntrycode").isin(Q22_CODES)
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(customer)),
        Declaration("project", ProjectNodeOptions(
            [field("c_custkey"),
             call("utf8_slice_codeunits", [field("c_phone")],
                  SliceOptions(0, 2)),
             field("c_acctbal")],
            ["c_custkey", "cntrycode", "c_acctbal"])),
        Declaration("filter", FilterNodeOptions(
            (field("c_acctbal") > literal(balance)) & in_set)),
    ])


def q22_declarations(customer: Table, orders: Table):
    """TPC-H Q22 (clause 2.4.22) as two Declarations: ``avg(customer)``,
    the scalar aggregate avg(c_acctbal) over the customers with
    c_acctbal > 0.00 and a code in the set, and ``rest(avg)``: the
    customers with c_acctbal > avg and a code in the set, left anti join
    orders on c_custkey = o_custkey (``not exists``), count_all as
    numcust and sum(c_acctbal) as totacctbal by cntrycode, ordered by
    cntrycode."""
    from .acero import (AggregateNodeOptions, Declaration,
                        OrderByNodeOptions, TableSourceNodeOptions)

    def avg_declaration():
        return Declaration.from_sequence([
            _q22_customers(customer, 0.0),
            Declaration("aggregate", AggregateNodeOptions(
                [AggregateSpec("mean", "c_acctbal", name="avg_acctbal")]))])

    def rest_declaration(avg: float):
        return Declaration.from_sequence([
            Declaration("hashjoin", HashJoinNodeOptions(
                "left anti", left_keys=["c_custkey"],
                right_keys=["o_custkey"],
                left_output=["cntrycode", "c_acctbal"], right_output=[],
                max_build_rows=max(orders.num_rows, 16)),
                inputs=[_q22_customers(customer, avg),
                        Declaration("table_source",
                                    TableSourceNodeOptions(orders))]),
            Declaration("aggregate", AggregateNodeOptions(
                [AggregateSpec("count_all", name="numcust"),
                 AggregateSpec("sum", "c_acctbal", name="totacctbal")],
                keys=["cntrycode"], max_groups=256)),
            Declaration("order_by", OrderByNodeOptions(
                [("cntrycode", "ascending")])),
        ])

    return avg_declaration, rest_declaration


def entry_q13(device=None, scale_factor: float = 0.01, seed: int = 42,
              max_groups: int = 1 << 21, max_batch_rows: int = 1 << 22,
              source=None):
    """(step, (customer, orders)): step(customer, orders) -> the Table of
    ``q13_declaration`` (c_count, custdist) run by
    ``Declaration.to_table``, over the port's TPC-H tables at
    ``scale_factor`` (customer's c_custkey; orders' o_orderkey,
    o_custkey, o_comment), or over ``source`` (pyarrow tables by name,
    generated once for several queries). ``step.source`` holds the
    pyarrow tables (``q13_pyarrow``'s input)."""
    source, t = tpch_tables(scale_factor, seed, Q13_COLUMNS, max_batch_rows,
                            device, source)

    def step(customer: Table, orders: Table) -> Table:
        return q13_declaration(customer, orders, max_groups).to_table()

    step.source = source
    return step, (t["customer"], t["orders"])


def entry_q22(device=None, scale_factor: float = 0.01, seed: int = 42,
              max_batch_rows: int = 1 << 22, source=None):
    """(step, (customer, orders)): step(customer, orders) -> the Table of
    Q22 (cntrycode, numcust, totacctbal): ``q22_declarations``' scalar
    aggregate, ONE host read of its average, then the rest; over the
    generated tables or ``source``, as ``entry_q13``. ``step.source``
    holds the pyarrow tables (``q22_pyarrow``'s input)."""
    source, t = tpch_tables(scale_factor, seed, Q22_COLUMNS, max_batch_rows,
                            device, source)

    def step(customer: Table, orders: Table) -> Table:
        avg_decl, rest_decl = q22_declarations(customer, orders)
        avg = float(_host_column(avg_decl().to_table(), "avg_acctbal")[0])
        return rest_decl(avg).to_table()

    step.source = source
    return step, (t["customer"], t["orders"])


# ---- casts, temporal fields and set lookup: TPC-H Q12 and Q7 -------------

Q12_MODES = ("MAIL", "SHIP")
Q12_PRIORITIES = ("1-URGENT", "2-HIGH")
Q12_YEAR = 1994
Q7_NATIONS = ("FRANCE", "GERMANY")
Q12_COLUMNS = {"lineitem": ["l_orderkey", "l_shipdate", "l_commitdate",
                            "l_receiptdate", "l_shipmode"],
               "orders": ["o_orderkey", "o_orderpriority"]}
Q7_COLUMNS = {"supplier": ["s_suppkey", "s_nationkey"],
              "lineitem": ["l_orderkey", "l_suppkey", "l_shipdate",
                           "l_extendedprice", "l_discount"],
              "orders": ["o_orderkey", "o_custkey"],
              "customer": ["c_custkey", "c_nationkey"],
              "nation": ["n_nationkey", "n_name"]}


def q12_filter():
    """Q12's lineitem predicate: ``l_shipmode IN ('MAIL', 'SHIP')``,
    ``l_commitdate < l_receiptdate``, ``l_shipdate < l_commitdate`` and
    l_receiptdate in [1994-01-01, 1995-01-01) (date32 scalars)."""
    import datetime as _dtm
    from .compute.expressions import literal
    lo = literal(_dtm.date(Q12_YEAR, 1, 1))
    hi = literal(_dtm.date(Q12_YEAR + 1, 1, 1))
    return field("l_shipmode").isin(Q12_MODES) & \
        (field("l_commitdate") < field("l_receiptdate")) & \
        (field("l_shipdate") < field("l_commitdate")) & \
        (field("l_receiptdate") >= lo) & (field("l_receiptdate") < hi)


def q12_declaration(lineitem, orders, build_rows: Optional[int] = None):
    """TPC-H Q12 (clause 2.4.12) as a Declaration: lineitem filtered by
    ``q12_filter`` (``is_in`` on the dictionary) -> join orders on
    o_orderkey = l_orderkey -> high_line_count =
    sum(cast(is_in(o_orderpriority, ('1-URGENT', '2-HIGH')), int64)) and
    low_line_count the same of its inverse (TPC-H's CASE as a cast) by
    l_shipmode, ordered by l_shipmode. ``lineitem`` and ``orders`` are
    Tables, or Declarations of their sources (a lineitem source applies
    ``q12_filter`` itself, as a dataset scan does); ``build_rows``: the
    orders' rows where ``orders`` is not a Table."""
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, OrderByNodeOptions,
                        ProjectNodeOptions, TableSourceNodeOptions)
    from .core import datatype as dt
    if isinstance(lineitem, Table):
        lineitem = Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(lineitem)),
            Declaration("filter", FilterNodeOptions(q12_filter()))])
    if isinstance(orders, Table):
        build_rows = orders.num_rows
        orders = Declaration("table_source", TableSourceNodeOptions(orders))
    urgent = field("o_orderpriority").isin(Q12_PRIORITIES)
    return Declaration.from_sequence([
        Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_shipmode"], right_output=["o_orderpriority"],
            max_build_rows=max(build_rows, 16)),
            inputs=[lineitem, orders]),
        Declaration("project", ProjectNodeOptions(
            [field("l_shipmode"), urgent.cast(dt.int64),
             (~urgent).cast(dt.int64)],
            ["l_shipmode", "high", "low"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "high", name="high_line_count"),
             AggregateSpec("sum", "low", name="low_line_count")],
            keys=["l_shipmode"], max_groups=16)),
        Declaration("order_by", OrderByNodeOptions(
            [("l_shipmode", "ascending")])),
    ])


def q7_declaration(supplier: Table, lineitem: Table, orders: Table,
                   customer: Table, nation: Table):
    """TPC-H Q7 (clause 2.4.7) as a Declaration: each nation side is
    ``n_name IN ('FRANCE', 'GERMANY')``; supplier joins its nation
    (supp_nation), customer its nation (cust_nation), orders its customer;
    lineitem with l_shipdate between 1995-01-01 and 1996-12-31 joins its
    supplier, then its order; the pair predicate keeps (FRANCE, GERMANY)
    and (GERMANY, FRANCE); l_year = year(l_shipdate) (the temporal field
    on the device), volume = l_extendedprice * (1 - l_discount);
    sum(volume) as revenue by (supp_nation, cust_nation, l_year),
    ordered."""
    import datetime as _dtm
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, OrderByNodeOptions,
                        ProjectNodeOptions, TableSourceNodeOptions)
    from .compute.expressions import call, literal

    def source(t):
        return Declaration("table_source", TableSourceNodeOptions(t))

    def nation_side(key, name):
        return Declaration.from_sequence([
            source(nation),
            Declaration("filter", FilterNodeOptions(
                field("n_name").isin(Q7_NATIONS))),
            Declaration("project", ProjectNodeOptions(
                [field("n_nationkey"), field("n_name")], [key, name]))])

    def join(left, right, lk, rk, lout, rout, build_rows):
        return Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=[lk], right_keys=[rk], left_output=lout,
            right_output=rout, max_build_rows=max(build_rows, 16)),
            inputs=[left, right])

    supp = join(source(supplier), nation_side("s_nk", "supp_nation"),
                "s_nationkey", "s_nk", ["s_suppkey"], ["supp_nation"], 25)
    cust = join(source(customer), nation_side("c_nk", "cust_nation"),
                "c_nationkey", "c_nk", ["c_custkey"], ["cust_nation"], 25)
    ords = join(source(orders), cust, "o_custkey", "c_custkey",
                ["o_orderkey"], ["cust_nation"], customer.num_rows)
    shipped = Declaration.from_sequence([
        source(lineitem),
        Declaration("filter", FilterNodeOptions(
            (field("l_shipdate") >= literal(_dtm.date(1995, 1, 1))) &
            (field("l_shipdate") <= literal(_dtm.date(1996, 12, 31)))))])
    li = join(shipped, supp, "l_suppkey", "s_suppkey",
              ["l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"],
              ["supp_nation"], supplier.num_rows)
    full = join(li, ords, "l_orderkey", "o_orderkey",
                ["supp_nation", "l_shipdate", "l_extendedprice",
                 "l_discount"], ["cust_nation"], orders.num_rows)
    a, b = Q7_NATIONS
    pair = ((field("supp_nation") == a) & (field("cust_nation") == b)) | \
        ((field("supp_nation") == b) & (field("cust_nation") == a))
    return Declaration.from_sequence([
        full,
        Declaration("filter", FilterNodeOptions(pair)),
        Declaration("project", ProjectNodeOptions(
            [field("supp_nation"), field("cust_nation"),
             call("year", [field("l_shipdate")]),
             field("l_extendedprice") * (1.0 - field("l_discount"))],
            ["supp_nation", "cust_nation", "l_year", "volume"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "volume", name="revenue")],
            keys=["supp_nation", "cust_nation", "l_year"], max_groups=64)),
        Declaration("order_by", OrderByNodeOptions(
            [("supp_nation", "ascending"), ("cust_nation", "ascending"),
             ("l_year", "ascending")])),
    ])


def entry_q12(device=None, scale_factor: float = 0.01, seed: int = 42,
              max_batch_rows: int = 1 << 22, source=None):
    """(step, (lineitem, orders)): step(lineitem, orders) -> the Table of
    ``q12_declaration`` (l_shipmode, high_line_count, low_line_count) run
    by ``Declaration.to_table``, over the port's TPC-H tables at
    ``scale_factor`` (only ``Q12_COLUMNS``) or over ``source``, as
    ``entry_q13``. ``step.source`` holds the pyarrow tables
    (``q12_pyarrow``'s input)."""
    source, t = tpch_tables(scale_factor, seed, Q12_COLUMNS, max_batch_rows,
                            device, source)

    def step(lineitem: Table, orders: Table) -> Table:
        return q12_declaration(lineitem, orders).to_table()

    step.source = source
    return step, (t["lineitem"], t["orders"])


def entry_q7(device=None, scale_factor: float = 0.01, seed: int = 42,
             max_batch_rows: int = 1 << 22, source=None):
    """(step, (supplier, lineitem, orders, customer, nation)): step(...) ->
    the Table of ``q7_declaration`` (supp_nation, cust_nation, l_year,
    revenue), over the port's TPC-H tables at ``scale_factor`` (only
    ``Q7_COLUMNS``) or over ``source``, as ``entry_q13``."""
    source, t = tpch_tables(scale_factor, seed, Q7_COLUMNS, max_batch_rows,
                            device, source)

    def step(supplier: Table, lineitem: Table, orders: Table,
             customer: Table, nation: Table) -> Table:
        return q7_declaration(supplier, lineitem, orders, customer,
                              nation).to_table()

    step.source = source
    return step, tuple(t[n] for n in ("supplier", "lineitem", "orders",
                                       "customer", "nation"))


# ---- nested layouts: a word count over o_comment, order baskets ------------

WORDCOUNT_COLUMNS = {"orders": ["o_comment"]}
BASKETS_COLUMNS = {"lineitem": ["l_orderkey", "l_partkey", "l_linenumber",
                                "l_quantity"]}
BASKET_LINES = tuple(str(i) for i in range(1, 8))
BASKET_MIN_PARTS = 5


def wordcount_words(comments):
    """``list_flatten(utf8_split_whitespace(comments))``: every word of a
    string column, in order."""
    from .compute import call_function
    return call_function("list_flatten", [call_function(
        "utf8_split_whitespace", [comments])])


def wordcount_declaration(words: Table, max_groups: int = 1 << 16):
    """count_all by ``word`` (a raw string key), ordered by the count
    descending, then the word ascending."""
    from .acero import AggregateNodeOptions, Declaration, \
        OrderByNodeOptions, TableSourceNodeOptions
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(words)),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("count_all", None, None, "count")], ["word"],
            max_groups=max_groups)),
        Declaration("order_by", OrderByNodeOptions(
            [("count", "descending"), ("word", "ascending")])),
    ])


def entry_wordcount(device=None, scale_factor: float = 0.01, seed: int = 42,
                    max_batch_rows: int = 1 << 22, max_groups: int = 1 << 16,
                    source=None):
    """(step, (orders,)): HiBench's WordCount over TPC-H's ``o_comment``:
    step(orders) -> the Table (word, count) of every distinct word, the
    most frequent first (``wordcount_declaration``), each batch's words
    from ``wordcount_words`` on the device. Over the port's TPC-H orders
    at ``scale_factor`` or ``source``, as ``entry_q13``. ``step.source``
    holds the pyarrow table (``wordcount_pyarrow``'s input)."""
    from .core.schema import Field, Schema
    source, t = tpch_tables(scale_factor, seed, WORDCOUNT_COLUMNS,
                            max_batch_rows, device, source)

    def step(orders: Table) -> Table:
        words = [wordcount_words(b.column("o_comment"))
                 for b in orders.batches]
        table = Table(Schema((Field("word", words[0].type, True),)),
                      [Batch(Schema((Field("word", w.type, True),)), [w],
                             w.length) for w in words])
        return wordcount_declaration(table, max_groups).to_table()

    step.source = source
    return step, (t["orders"],)


def baskets_declaration(lineitem: Table, max_groups: int,
                        buffer_rows: int):
    """Order baskets (FPGrowth's input): lineitem -> ``ln =
    cast(l_linenumber, utf8)`` -> by l_orderkey, ``parts =
    hash_list(l_partkey)`` (``buffer_rows``) and ``qty =
    hash_pivot_wider((ln, l_quantity))`` over the line numbers "1".."7"
    -> n = list_value_length(parts), first = list_element(parts, 0),
    top3 = list_slice(parts, 0, 3), q1 = struct_field(qty, "1") -> the
    baskets of at least ``BASKET_MIN_PARTS`` parts."""
    from types import SimpleNamespace

    from .acero import AggregateNodeOptions, Declaration, \
        FilterNodeOptions, ProjectNodeOptions, TableSourceNodeOptions
    from .compute.expressions import call, literal
    from .core import datatype as dt
    from .ops.agg_options import PivotWiderOptions
    from .ops.nested import ListSliceOptions, StructFieldOptions
    from .ops.scalar_cast import CastOptions
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(lineitem)),
        Declaration("project", ProjectNodeOptions(
            [field("l_orderkey"), field("l_partkey"), field("l_quantity"),
             call("cast", [field("l_linenumber")], CastOptions(dt.string))],
            ["l_orderkey", "l_partkey", "l_quantity", "ln"])),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("hash_list", "l_partkey",
                           SimpleNamespace(buffer_rows=buffer_rows),
                           "parts"),
             AggregateSpec("hash_pivot_wider", ("ln", "l_quantity"),
                           PivotWiderOptions(list(BASKET_LINES)), "qty")],
            ["l_orderkey"], max_groups=max_groups)),
        Declaration("project", ProjectNodeOptions(
            [field("l_orderkey"), field("parts"), field("qty"),
             call("list_value_length", [field("parts")]),
             call("list_element", [field("parts"), literal(0)]),
             call("list_slice", [field("parts")], ListSliceOptions(0, 3)),
             call("struct_field", [field("qty")],
                  StructFieldOptions(name="1"))],
            ["l_orderkey", "parts", "qty", "n", "first", "top3", "q1"])),
        Declaration("filter", FilterNodeOptions(call(
            "greater_equal", [field("n"), literal(BASKET_MIN_PARTS)]))),
    ])


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def entry_baskets(device=None, scale_factor: float = 0.01, seed: int = 42,
                  max_batch_rows: int = 1 << 22, source=None):
    """(step, (lineitem,)): step(lineitem) -> the Table of
    ``baskets_declaration`` over the port's TPC-H lineitem at
    ``scale_factor`` (``BASKETS_COLUMNS``) or ``source``, as ``entry_q13``;
    ``max_groups`` the power of two at or above the order count (1.5M
    orders per unit of scale), ``buffer_rows`` at or above the staged
    batches' capacities (every consume buffers its batch's capacity).
    ``step.source`` holds the pyarrow table (``baskets_numpy``'s
    input)."""
    source, t = tpch_tables(scale_factor, seed, BASKETS_COLUMNS,
                            max_batch_rows, device, source)
    li = t["lineitem"]
    max_groups = _pow2_at_least(max(int(1_500_000 * scale_factor), 1024))
    buffer_rows = _pow2_at_least(sum(b.capacity for b in li.batches))

    def step(lineitem: Table) -> Table:
        return baskets_declaration(lineitem, max_groups,
                                   buffer_rows).to_table()

    step.source = source
    return step, (li,)


def entry_ree_keys(device=None, scale_factor: float = 0.01, seed: int = 42,
                   max_batch_rows: int = 1 << 22, source=None):
    """(step, (lineitem,)): a sorted key column run-end encoded and
    decoded: step(lineitem) -> [(encoded, decoded)] of each batch's
    ``l_orderkey`` (``run_end_encode_array``, whose run ends come from
    the two-level compaction; ``run_end_decode_array``, one host read of
    its row count). Over ``entry_baskets``' tables."""
    from .ops.ree import run_end_decode_array, run_end_encode_array
    source, t = tpch_tables(scale_factor, seed,
                            {"lineitem": ["l_orderkey"]}, max_batch_rows,
                            device, source)

    def step(lineitem: Table) -> list:
        out = []
        for b in lineitem.batches:
            enc = run_end_encode_array(b.column("l_orderkey"))
            out.append((enc, run_end_decode_array(enc)))
        return out

    step.source = source
    return step, (t["lineitem"],)


HB_WORDS = np.array([f"id{i % 977:03d}x{i % 31}" for i in range(4096)])


def example_columns_host_boundary(n_rows: int, seed: int):
    """bench.py's host_boundary columns, made with numpy from ``seed``:
    (int32 codes of ``s`` into ``HB_WORDS``, the 4,096 words
    ``id%03dx%d``, uniform; int64 ``v`` uniform in [0, 2^30))."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, len(HB_WORDS), n_rows).astype(np.int32),
            rng.integers(0, 1 << 30, n_rows))


def entry_host_boundary(device=None, n_rows: int = 1 << 17, seed: int = 7,
                        staging: str = "dictionary"):
    """(step, (batch,)): bench.py's host_boundary step,
    ``match_substring_regex(s, HB_PATTERN)`` then ``filter_batch``, over
    ``example_columns_host_boundary``'s ``s`` and ``v``. ``staging``
    "dictionary" stages ``s`` as a dictionary of its 4,096 words (as
    ingest encodes it: the regex's dictionary branch), "plain" as a varlen
    column (the regex's device pushdown)."""
    from .compute import call_function
    from .ops.strings import MatchSubstringOptions
    codes, v = example_columns_host_boundary(n_rows, seed)
    if staging == "dictionary":
        s = dictionary_from_numpy(codes, HB_WORDS, device=device)
    elif staging == "plain":
        words = np.char.encode(HB_WORDS, "ascii")
        lens = np.char.str_len(words)
        mat = words.view(np.uint8).reshape(len(words), -1)
        row_lens = lens[codes]
        off = np.zeros((n_rows + 1,), np.int64)
        np.cumsum(row_lens, out=off[1:])
        pool = mat[codes][np.arange(mat.shape[1])[None, :]
                          < row_lens[:, None]]
        s = varlen_from_numpy(offsets=off, pool=pool, device=device)
    else:
        raise ValueError(f"staging {staging!r}: 'dictionary' or 'plain'")
    b = batch({"s": s, "v": array_from_numpy(v, device=device)})
    opts = MatchSubstringOptions(HB_PATTERN)

    def step(batch_: Batch) -> Batch:
        m = call_function("match_substring_regex", [batch_.column("s")],
                          opts)
        return filter_batch(batch_, m)

    return step, (b,)


# one row in 16 of the string sweep: a non-ASCII string of the unit tests'
SWEEP_NON_ASCII = ("ß", "İstanbul", "ǆungla hello", "aΣb σc ΤΕΛΟΣ", "ﬃ",
                   "ǅenan ǄUNGLA", "𐐀𐐨 deseret", "ÉÀ-éà", "ẞß", "数字123",
                   "٣٤٥", "Ⅷ ⅷ", "héllo", "  éa  ", "　hi ", "añb")

# the 71 functions of the string family with their unit tests' options, as
# (function, further arguments, options)
STRING_SWEEP = tuple(
    [(f, (), {}) for f in (
        "binary_length", "utf8_length", "ascii_upper", "ascii_lower",
        "ascii_swapcase", "ascii_capitalize", "ascii_title",
        "ascii_reverse", "binary_reverse", "utf8_upper", "utf8_lower",
        "utf8_swapcase", "utf8_capitalize", "utf8_title", "utf8_reverse",
        "ascii_is_alnum", "ascii_is_alpha", "ascii_is_decimal",
        "ascii_is_space", "ascii_is_printable", "string_is_ascii",
        "utf8_is_alnum", "utf8_is_alpha", "utf8_is_decimal",
        "utf8_is_digit", "utf8_is_numeric", "utf8_is_space",
        "utf8_is_printable", "ascii_is_lower", "ascii_is_upper",
        "utf8_is_lower", "utf8_is_upper", "ascii_is_title",
        "utf8_is_title", "utf8_trim_whitespace", "utf8_ltrim_whitespace",
        "utf8_rtrim_whitespace", "ascii_trim_whitespace",
        "ascii_ltrim_whitespace", "ascii_rtrim_whitespace")]
    + [("match_substring", (), {"pattern": "ab"}),
       ("find_substring", (), {"pattern": "ab"}),
       ("count_substring", (), {"pattern": "ab"}),
       ("starts_with", (), {"pattern": "ab"}),
       ("ends_with", (), {"pattern": "b"}),
       ("match_like", (), {"pattern": "%foo%"}),
       ("binary_slice", (), {"start": 1, "stop": 100, "step": 2}),
       ("utf8_slice_codeunits", (), {"start": 1, "stop": 100, "step": 2})]
    + [(f, (), {"characters": " x"}) for f in (
        "utf8_trim", "utf8_ltrim", "utf8_rtrim", "ascii_trim",
        "ascii_ltrim", "ascii_rtrim")]
    + [(f, (), {"width": 7 if f.endswith("center") else 6,
                 "padding": "*"}) for f in (
        "utf8_lpad", "utf8_rpad", "utf8_center", "ascii_lpad",
        "ascii_rpad", "ascii_center")]
    + [("binary_repeat", (3,), {}),
       ("binary_join_element_wise", ("-",), {}),
       ("replace_substring", (), {"pattern": "ab", "replacement": "XYZ"}),
       ("match_substring_regex", (), {"pattern": "^h.*d$"}),
       ("count_substring_regex", (), {"pattern": "[lo]"}),
       ("find_substring_regex", (), {"pattern": "o"}),
       ("replace_substring_regex", (), {"pattern": "[aeiou]",
                                        "replacement": "_"}),
       ("binary_replace_slice", (), {"start": 1, "stop": 3,
                                     "replacement": "XY"}),
       ("utf8_replace_slice", (), {"start": 0, "stop": 1,
                                   "replacement": "é"}),
       ("utf8_zero_fill", (), {"width": 5}),
       ("utf8_normalize", (), {"form": "NFD"})])


def sweep_column(values, device=None, every: int = 16, null_every: int = 97):
    """The string sweep's input: ``values`` (str) with every ``every``-th
    row replaced by a string of ``SWEEP_NON_ASCII`` and every
    ``null_every``-th (others) null."""
    vals = list(values)
    for i in range(0, len(vals), every):
        vals[i] = SWEEP_NON_ASCII[(i // every) % len(SWEEP_NON_ASCII)]
    valid = (np.arange(len(vals)) % null_every != 1)
    return varlen_from_numpy(np.array(vals), validity=valid, device=device)


def sweep_call(name: str, extra: tuple, kw: dict, col):
    """One function of ``STRING_SWEEP`` on the column ``col`` (the join
    joins the column with itself)."""
    from .compute import call_function
    args = [col, col, *extra] if name == "binary_join_element_wise" \
        else [col, *extra]
    return call_function(name, args, **kw)


# ---- the A7b sweep: casts, temporal, checked, vector_misc, set lookup ---

# the temporal types of the cast sweep: (column, type name, unit)
A7B_TEMPORAL = (("ts_s", "timestamp", "s"), ("ts_ms", "timestamp", "ms"),
                ("ts_us", "timestamp", "us"), ("ts_ns", "timestamp", "ns"),
                ("date32", "date32", None), ("date64", "date64", None),
                ("t32_s", "time32", "s"), ("t32_ms", "time32", "ms"),
                ("t64_us", "time64", "us"), ("t64_ns", "time64", "ns"),
                ("dur_s", "duration", "s"), ("dur_ms", "duration", "ms"),
                ("dur_us", "duration", "us"), ("dur_ns", "duration", "ns"))
A7B_NUMERIC = (("i8", "int8"), ("i16", "int16"), ("i32", "int32"),
               ("i64", "int64"), ("u8", "uint8"), ("u16", "uint16"),
               ("u32", "uint32"), ("u64", "uint64"), ("f16", "float16"),
               ("f32", "float32"), ("f64", "float64"), ("b", "bool_"))
A7B_ZONES = ("America/New_York", "Europe/Paris")
_A7B_FIELDS = ("year", "month", "day", "quarter", "day_of_year", "hour",
               "minute", "second", "millisecond", "microsecond",
               "nanosecond", "subsecond", "is_leap_year", "iso_year",
               "iso_week", "us_year", "us_week")
_A7B_FLOAT_CHECKED = (("sqrt_checked", "pos"), ("ln_checked", "pos"),
                      ("log2_checked", "pos"), ("log10_checked", "pos"),
                      ("log1p_checked", "pos"), ("sin_checked", "unit"),
                      ("cos_checked", "unit"), ("tan_checked", "unit"),
                      ("asin_checked", "unit"), ("acos_checked", "unit"),
                      ("atanh_checked", "unit"), ("acosh_checked", "ge1"))


def _temporal_type(kind: str, unit):
    from .core import datatype as dt
    t = getattr(dt, kind)
    return t(unit) if unit else t


def _a7b_entries():
    """(label, function, argument columns, options, tolerance) of the
    sweep. The tolerance is None (byte for byte), ("ulps", k) or ("sum",
    rtol): |diff| <= rtol * the running sum of |x| of the first
    argument."""
    from .core import datatype as dt
    e = []
    numeric = {c: getattr(dt, n) for c, n in A7B_NUMERIC}
    temporal = {c: _temporal_type(k, u) for c, k, u in A7B_TEMPORAL}
    for src in numeric:                       # numeric and bool pairs
        for dst, n in A7B_NUMERIC:
            e.append((f"cast:{src}->{dst}", "cast", (src,),
                      {"target_type": numeric[dst]}, None))
    for src in temporal:                      # temporal pairs
        for dst, t in temporal.items():
            e.append((f"cast:{src}->{dst}", "cast", (src,),
                      {"target_type": t}, None))
    for c, t in temporal.items():             # temporal <-> int64
        e.append((f"cast:{c}->i64", "cast", (c,),
                  {"target_type": dt.int64}, None))
        e.append((f"cast:i64->{c}", "cast", ("i64",),
                  {"target_type": t}, None))
    for src in list(numeric) + ["ts_s", "ts_ms", "ts_us", "ts_ns", "date32",
                                "date64"]:  # to string
        e.append((f"cast:{src}->string", "cast", (src,),
                  {"target_type": dt.string}, None))
    for dst, n in A7B_NUMERIC[:8]:            # from string
        e.append((f"cast:s_int->{dst}", "cast", ("s_int",),
                  {"target_type": numeric[dst]}, None))
    for dst in ("f32", "f64"):
        e.append((f"cast:s_float->{dst}", "cast", ("s_float",),
                  {"target_type": numeric[dst]}, ("ulps", 2)))
    e.append(("cast:s_bool->b", "cast", ("s_bool",),
              {"target_type": dt.bool_}, None))
    for dst in ("ts_s", "ts_ms", "ts_us", "ts_ns", "date32", "date64"):
        e.append((f"cast:s_date->{dst}", "cast", ("s_date",),
                  {"target_type": temporal[dst]}, None))
    e.append(("cast:d_mode->string", "cast", ("d_mode",),
              {"target_type": dt.string}, None))
    e.append(("cast:s_bool->dictionary", "cast", ("s_bool",),
              {"target_type": dt.dictionary(dt.int32, dt.string)}, None))
    # temporal: fields of the naive and the zoned ns timestamps
    for col in ("ts_ns", "ts_ny", "ts_paris"):
        for f in _A7B_FIELDS + ("day_of_week", "week"):
            e.append((f"{f}:{col}", f, (col,), {}, None))
    e += [("year_month_day", "year_month_day", ("date32",), {}, None),
          ("iso_calendar", "iso_calendar", ("date32",), {}, None)]
    for m in ("floor", "ceil", "round"):
        e.append((f"{m}_temporal", f"{m}_temporal", ("ts_ns",),
                  {"multiple": 15, "unit": "minute"}, None))
    e += [("strftime", "strftime", ("ts_s",),
           {"format": "%Y-%m-%d %H:%M:%S"}, None),
          ("strptime", "strptime", ("s_ts",),
           {"format": "%Y-%m-%d %H:%M:%S", "unit": "s"}, None)]
    for u in ("years", "quarters", "weeks", "days", "hours", "minutes",
              "seconds", "milliseconds", "microseconds", "nanoseconds"):
        e.append((f"{u}_between", f"{u}_between", ("ts_ns", "ts_ns2"), {},
                  None))
    for f in ("month_interval_between", "day_time_interval_between",
              "month_day_nano_interval_between"):
        e.append((f, f, ("ts_ns", "ts_ns2"), {}, None))
    e += [("assume_timezone", "assume_timezone", ("ts_ns",),
           {"timezone": "America/New_York"}, None),
          ("local_timestamp", "local_timestamp", ("ts_paris",), {}, None),
          ("is_dst", "is_dst", ("ts_ny",), {}, None)]
    # checked arithmetic, on inputs that do not wrap
    for f in ("add_checked", "subtract_checked", "multiply_checked",
              "divide_checked"):
        e.append((f, f, ("c_a", "c_b"), {}, None))
    e += [("shift_left_checked", "shift_left_checked", ("c_a", "c_sh"), {},
           None),
          ("shift_right_checked", "shift_right_checked", ("c_a", "c_sh"),
           {}, None),
          ("power_checked", "power_checked", ("c_base", "c_exp"), {}, None),
          ("negate_checked", "negate_checked", ("c_a",), {}, None),
          ("abs_checked", "abs_checked", ("c_a",), {}, None),
          ("logb_checked", "logb_checked", ("pos", "ge1"), {},
           ("ulps", 4))]
    for f, col in _A7B_FLOAT_CHECKED:
        e.append((f, f, (col,), {}, ("ulps", 2)))
    e += [("cumulative_sum_checked", "cumulative_sum_checked", ("c_a",), {},
           None),
          ("cumulative_prod_checked", "cumulative_prod_checked", ("ones",),
           {}, None),
          ("pairwise_diff_checked", "pairwise_diff_checked", ("c_a",),
           {"period": 3}, None)]
    # vector_misc
    e += [("cumulative_sum", "cumulative_sum", ("f64n",),
           {"skip_nulls": True}, ("sum", 1e-12)),
          ("cumulative_sum:f32", "cumulative_sum", ("f32n",),
           {"skip_nulls": True}, ("sum", 1e-5)),
          ("cumulative_prod", "cumulative_prod", ("ones",), {}, None),
          ("cumulative_min", "cumulative_min", ("f64n",), {}, None),
          ("cumulative_max", "cumulative_max", ("i64",),
           {"skip_nulls": True}, None),
          ("cumulative_mean", "cumulative_mean", ("f64n",),
           {"skip_nulls": True}, ("sum", 1e-12)),
          ("pairwise_diff", "pairwise_diff", ("i32",), {"period": 2}, None),
          ("replace_with_mask", "replace_with_mask", ("f64", "b", "f64n"),
           {}, None),
          ("fill_null_forward", "fill_null_forward", ("i64",), {}, None),
          ("fill_null_backward", "fill_null_backward", ("f32",), {}, None),
          ("indices_nonzero", "indices_nonzero", ("i8",), {}, None),
          ("scatter", "scatter", ("f64", "perm"), {}, None)]
    # set lookup
    e += [("is_in", "is_in", ("d_mode",), {"value_set": list(Q12_MODES)},
           None),
          ("index_in", "index_in", ("i16",), {"value_set": [3, -7, 11, 0]},
           None),
          ("is_in:string", "is_in", ("s_int",),
           {"value_set": ["13", "-7", "0"]}, None),
          ("is_in_meta_binary", "is_in_meta_binary", ("i64", "vset"), {},
           None),
          ("index_in_meta_binary", "index_in_meta_binary", ("i64", "vset"),
           {}, None)]
    return tuple(e)


def a7b_sweep_columns(n_rows: int, seed: int, shipdate: np.ndarray,
                      shipmode_codes: np.ndarray, device=None) -> dict:
    """The sweep's input columns, made with numpy from ``seed`` (the same
    on every device): every integer and float width (one row in 97 null;
    the floats with NaN, infinities and values past every integer range),
    a bool, Q7's ``l_shipdate`` (``shipdate``, days) as date32 and
    date64, ``l_shipmode`` as a dictionary of its seven names, an
    instant over 1900-2100 with its nanosecond digits at every unit, naive
    and in ``A7B_ZONES``, times of day, durations, strings of integers,
    floats, dates, timestamps and bools, and the checked functions'
    inputs, which do not wrap."""
    from .core import datatype as dt
    rng = np.random.default_rng(seed)
    n = n_rows
    valid = np.arange(n) % 97 != 5

    def col(values, t, nullable=True):
        return array_from_numpy(values, type=t, device=device,
                                validity=valid if nullable else None)

    out = {}
    for c, name in A7B_NUMERIC:
        t = getattr(dt, name)
        if name == "bool_":
            v = rng.random(n) < 0.5
        elif name.startswith("float"):
            v = rng.standard_normal(n) * 10.0 ** rng.integers(-3, 12, n)
            v[::101] = np.array([np.nan, np.inf, -np.inf, 3e10, -2.9, 1e19,
                                 2.0 ** 64, -0.5])[np.arange(
                                     len(v[::101])) % 8]
            with np.errstate(over="ignore"):
                v = v.astype(t.storage_np)
        else:
            info = np.iinfo(t.storage_np)
            v = rng.integers(info.min, info.max, n, dtype=t.storage_np,
                             endpoint=True)
        out[c] = col(v, t)
    per = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}
    secs = rng.integers(-2_208_988_800, 4_102_444_800, n)
    nanos = rng.integers(0, 10**9, n)
    for u, p in per.items():
        out[f"ts_{u}"] = col(secs * p + nanos // (10**9 // p),
                             dt.timestamp(u))
    out["ts_ns2"] = col(rng.integers(-2_208_988_800, 4_102_444_800, n)
                        * 10**9 + rng.integers(0, 10**9, n),
                        dt.timestamp("ns"))
    ns = secs * 10**9 + nanos
    out["ts_ny"] = col(ns, dt.timestamp("ns", A7B_ZONES[0]))
    out["ts_paris"] = col(ns, dt.timestamp("ns", A7B_ZONES[1]))
    days = np.asarray(shipdate[:n], dtype=np.int32)
    out["date32"] = col(days, dt.date32)
    out["date64"] = col(days.astype(np.int64) * 86_400_000, dt.date64)
    tod = rng.integers(0, 86_400 * 10**9, n)
    for c, k, u in A7B_TEMPORAL[6:10]:
        out[c] = col(tod // (10**9 // per[u]), _temporal_type(k, u))
    for u, p in per.items():
        out[f"dur_{u}"] = col(rng.integers(-10**6, 10**6, n) * p,
                              dt.duration(u))
    out["d_mode"] = dictionary_from_numpy(
        np.asarray(shipmode_codes[:n], dtype=np.int32),
        np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]),
        validity=valid, device=device)
    ints = rng.integers(-10**6, 10**6, n)
    ints[::13] = rng.integers(-2**62, 2**62, len(ints[::13]))
    text = ints.astype(str)
    text[::17] = "12a"
    out["s_int"] = varlen_from_numpy(text, validity=valid, device=device)
    out["s_float"] = varlen_from_numpy(
        (rng.standard_normal(n) * 10.0 ** rng.integers(-5, 9, n)).astype(str),
        validity=valid, device=device)
    iso = (np.datetime64("1970-01-01") + days.astype("timedelta64[D]"))
    out["s_date"] = varlen_from_numpy(iso.astype(str), validity=valid,
                                      device=device)
    stamps = (np.datetime64("1970-01-01T00:00:00") +
              (secs % (200 * 365 * 86_400)).astype("timedelta64[s]"))
    out["s_ts"] = varlen_from_numpy(
        np.char.replace(stamps.astype(str), "T", " "), validity=valid,
        device=device)
    out["s_bool"] = varlen_from_numpy(
        np.array(["true", "False", "1", "0", "yes"])[rng.integers(0, 5, n)],
        validity=valid, device=device)
    out["c_a"] = col(rng.integers(-10**6, 10**6, n), dt.int64)
    out["c_b"] = col(rng.integers(1, 1000, n) * rng.choice([-1, 1], n),
                     dt.int64)
    out["c_sh"] = col(rng.integers(0, 20, n), dt.int64)
    out["c_base"] = col(rng.integers(-3, 4, n), dt.int64)
    out["c_exp"] = col(rng.integers(0, 11, n), dt.int64)
    out["ones"] = col(rng.choice([1, -1], n), dt.int64)
    out["pos"] = col(rng.uniform(0.1, 10.0, n), dt.float64)
    out["unit"] = col(rng.uniform(-0.99, 0.99, n), dt.float64)
    out["ge1"] = col(rng.uniform(1.5, 10.0, n), dt.float64)
    out["f64n"] = col(rng.standard_normal(n), dt.float64)
    out["f32n"] = col(rng.standard_normal(n).astype(np.float32), dt.float32)
    out["perm"] = col(rng.permutation(n).astype(np.int32), dt.int32,
                      nullable=False)
    vset = np.zeros(n, np.int64)
    vset[:4] = out["i64"].values[:4].cpu().numpy()
    out["vset"] = array_from_numpy(vset[:4], capacity=n, device=device)
    return out


A7B_SWEEP = _a7b_entries()


def a7b_sweep_call(entry, cols: dict):
    """One entry of ``A7B_SWEEP`` on the columns of
    ``a7b_sweep_columns``."""
    from .compute import call_function
    _, fn, names, kw, _ = entry
    return call_function(fn, [cols[c] for c in names], **kw)


# ---- the distribution --------------------------------------------------------

def entry_q3_dist(device=None, n_shards: int = 8, n_lineitem: int = 768,
                  seed: int = 0, max_groups: int = 256,
                  max_batch_rows: int = 64, segment: Optional[str] = None):
    """(step, (lineitem, orders, customer)): ``entry_q3`` with ``dist=`` a
    ``DistContext`` of ``n_shards`` logical shards of ``device`` on both
    joins and the aggregate (``max_groups`` then bounds each shard's
    groups, and nothing doubles it); with ``segment`` (``"BUILDING"``:
    the same answer), ``entry_q3s``'s tables and filter on the dictionary
    ``c_mktsegment``. ``step.ctx`` is the context."""
    device = resolve_device(device)
    tables = _q3_tables(device, n_lineitem, seed, max_batch_rows,
                       segment is not None)
    ctx = DistContext(devices=[device] * n_shards)

    def step(li_: Table, od_: Table, cu_: Table) -> Table:
        return q3_declaration(li_, od_, cu_, max_groups, dist=ctx,
                              segment=segment).to_table()

    step.ctx = ctx
    return step, tables


def entry_dist_join(device=None, n_shards: int = 8, n_build: int = 256,
                    n_probe: int = 1024, seed: int = 0,
                    join_type: str = "inner"):
    """(step, (build batch, probe batch)): step -> ``DistContext.join`` of
    ``example_columns_join``'s uniform probe keys against its build
    permutation over ``n_shards`` logical shards of ``device``: the Table
    with one batch per shard, each row on the shard its key's hash names.
    Output columns: the probe side's ``k`` and ``lv``, the build side's
    ``rv``."""
    device = resolve_device(device)
    bcols, pcols = example_columns_join(n_build, n_probe, seed)
    bb = batch_from_numpy(bcols, device=device)
    pb = batch_from_numpy(pcols, device=device)
    ctx = DistContext(devices=[device] * n_shards)
    options = HashJoinNodeOptions(join_type, left_keys=["k"],
                                  right_keys=["k"], right_output=["rv"],
                                  max_build_rows=n_build)

    def step(build_batch: Batch, probe_batch: Batch) -> Table:
        return ctx.join(probe_batch, build_batch, options)

    step.ctx = ctx
    return step, (bb, pb)


def entry_dist_sort(device=None, n_shards: int = 8, n_rows: int = 1024,
                    seed: int = 0, num_keys: int = 64,
                    bucket_factor: int = 3):
    """(step, (batch,)): step -> ``DistContext.sort_by`` of
    ``entry_sort``'s batch by ``SORT_KEYS`` (nulls at the end) over
    ``n_shards`` logical shards of ``device``: the Table whose batches, in
    order, are the sorted rows."""
    device = resolve_device(device)
    (b,) = entry_sort(device, n_rows, seed, num_keys)[1]
    ctx = DistContext(devices=[device] * n_shards)

    def step(batch_: Batch) -> Table:
        return ctx.sort_by(batch_, SORT_KEYS, bucket_factor=bucket_factor)

    step.ctx = ctx
    return step, (b,)


def entry_dist_dict(device=None, n_shards: int = 8, n_rows: int = 1024,
                    num_keys: int = 16, max_groups_per_shard: int = 64,
                    seed: int = 0):
    """(step, (batch,)): ``entry_distributed`` keyed by a string: ``name``,
    a dictionary<int32, utf8> over the ``num_keys`` TPC-H ``C_NAME``
    values ``Customer#%09d`` of custkeys 1 .. num_keys, whose indices are
    ``example_columns_generic``'s ``k``. The state-row exchange hashes and
    merges the codes by the names they stand for."""
    device = resolve_device(device)
    cols = example_columns_generic(n_rows, num_keys, seed)
    off, pool = numbered_strings(b"Customer#", np.arange(1, num_keys + 1), 9)
    names = varlen_from_numpy(offsets=off, pool=pool, device=device)
    b = batch({"name": dictionary_from_numpy(cols["k"].astype(np.int32),
                                             names, device=device),
               "v": array_from_numpy(cols["v"], device=device),
               "w": array_from_numpy(cols["w"], device=device)})
    ctx = DistContext(devices=[device] * n_shards)
    predicate = field("w") > 0

    def step(batch_: Batch) -> Table:
        return ctx.group_by(batch_, ["name"], AGGREGATES_GENERIC,
                            max_groups_per_shard=max_groups_per_shard,
                            pre_filter=predicate)

    step.ctx = ctx
    return step, (b,)


SORT_KEYS_DIST_DICT = (("k1", "ascending"), ("s", "descending"))


def example_columns_sort_dist_dict(n_rows: int, num_keys: int, seed: int,
                                   num_values: int = 1000
                                   ) -> Dict[str, np.ndarray]:
    """``entry_dist_sort_dict``'s columns, made with numpy from ``seed``:
    int64 ``k1`` uniform in [0, num_keys); ``s_idx`` int32 uniform in [0,
    num_values) with ``s_valid`` False for 5 % of the rows (indices into
    the values ``cat%04d``); float64 standard normal ``v``."""
    rng = np.random.default_rng(seed)
    return {"k1": rng.integers(0, num_keys, n_rows, dtype=np.int64),
            "s_idx": rng.integers(0, num_values, n_rows, dtype=np.int32),
            "s_valid": rng.random(n_rows) >= 0.05,
            "v": rng.standard_normal(n_rows)}


def entry_dist_sort_dict(device=None, n_shards: int = 8, n_rows: int = 1024,
                         seed: int = 0, num_keys: int = 64,
                         num_values: int = 1000, bucket_factor: int = 3):
    """(step, (batch,)): ``entry_dist_sort`` with BASELINE #3's string key
    in ``k2``'s place: ``DistContext.sort_by`` by ``SORT_KEYS_DIST_DICT``
    (``k1`` ascending, then ``s``, a dictionary<int32, utf8> over
    ``cat%04d`` with 5 % nulls, descending), nulls at the end, over
    ``n_shards`` logical shards of ``device``. Its step returns the
    Table, one batch per shard in key-range order."""
    device = resolve_device(device)
    cols = example_columns_sort_dist_dict(n_rows, num_keys, seed, num_values)
    b = batch({"k1": array_from_numpy(cols["k1"], device=device),
               "s": _cat_column(cols, num_values, device),
               "v": array_from_numpy(cols["v"], device=device)})
    ctx = DistContext(devices=[device] * n_shards)

    def step(batch_: Batch) -> Table:
        return ctx.sort_by(batch_, SORT_KEYS_DIST_DICT,
                           bucket_factor=bucket_factor)

    step.ctx = ctx
    return step, (b,)


# ---- the other aggregators ---------------------------------------------------

AGGREGATES_ANY_ALL = (AggregateSpec("count_all"), AggregateSpec("sum", "v"),
                      AggregateSpec("min", "w"), AggregateSpec("any", "f"),
                      AggregateSpec("all", "f"))


def example_columns_any_all(n_rows: int, num_keys: int, seed: int
                            ) -> Dict[str, np.ndarray]:
    """``entry_any_all``'s columns, made with numpy from ``seed``:
    ``example_columns``' ``k``, ``v`` and ``w``, and a bool ``f`` that is
    False for every key = 1 (mod 4), True for every key = 0 (mod 4) and
    uniform for the other keys, with ``f_valid`` False for 5 % of the
    rows."""
    cols = example_columns(n_rows, num_keys, seed)
    rng = np.random.default_rng(seed + 1)
    k4 = cols["k"] % 4
    cols["f"] = np.where(k4 == 0, True, np.where(
        k4 == 1, False, rng.random(n_rows) < 0.5))
    cols["f_valid"] = rng.random(n_rows) >= 0.05
    return cols


def entry_any_all(device=None, n_rows: int = 1024, num_keys: int = 16,
                  seed: int = 0, max_groups: int = MAX_GROUPS):
    """(step, (batch,)): ``entry``'s step (``w > 0``, the compaction-kernel
    filter, the dense route) with ``AGGREGATES_ANY_ALL``: count_all,
    sum(v), min(w), any(f) and all(f), the two bool aggregates as the dense
    kernel's ``any8`` / ``all8`` kinds over the bool column as it lies (a
    key domain past 4096 slots takes the sorted dense reduction)."""
    cols = example_columns_any_all(n_rows, num_keys, seed)
    b = batch({"k": array_from_numpy(cols["k"], device=device),
               "v": array_from_numpy(cols["v"], device=device),
               "w": array_from_numpy(cols["w"], device=device),
               "f": array_from_numpy(cols["f"], validity=cols["f_valid"],
                                     device=device)})
    ha = HashAggregate(b.schema, ["k"], AGGREGATES_ANY_ALL,
                       max_groups=max_groups)
    return _make_step(ha, "dma", False), (b,)


Q6_KEYS = ("id4", "id5")


def example_columns_q6(n_rows: int, seed: int, k: int = 100
                       ) -> Dict[str, np.ndarray]:
    """db-benchmark's groupby table ``G1_<n_rows>_<k>_0_0`` as its
    generator (``_data/groupby-datagen.R``) defines it, made with numpy from
    ``seed``: ``id1`` / ``id2`` codes of ``id%03d`` over k values and
    ``id3`` codes of ``id%010d`` over n_rows / k values (0-based indices
    into those strings), ``id4`` / ``id5`` int32 in [1, k], ``id6`` int32
    in [1, n_rows / k], ``v1`` int32 in [1, 5], ``v2`` int32 in [1, 15],
    ``v3`` float64 uniform in [0, 100) rounded to 6 digits; no nulls,
    unsorted."""
    rng = np.random.default_rng(seed)
    nk = max(n_rows // k, 1)

    def ints(lo, hi, dtype=np.int32):
        return rng.integers(lo, hi + 1, n_rows, dtype=dtype)
    return {"id1": ints(0, k - 1), "id2": ints(0, k - 1),
            "id3": ints(0, nk - 1), "id4": ints(1, k), "id5": ints(1, k),
            "id6": ints(1, nk), "v1": ints(1, 5), "v2": ints(1, 15),
            "v3": np.round(rng.random(n_rows) * 100.0, 6)}


def q6_aggregates(buffer_rows: int):
    """db-benchmark groupby q6, "median v3 sd v3 by id4 id5": the exact
    median (``approximate_median``'s buffer covering ``buffer_rows``) and
    the sample standard deviation (ddof 1)."""
    from .ops.agg_options import VarianceOptions
    from .ops.aggregates_order import TDigestOptions
    return (AggregateSpec("approximate_median", "v3",
                          TDigestOptions(buffer_rows=buffer_rows),
                          name="median_v3"),
            AggregateSpec("stddev", "v3", VarianceOptions(ddof=1),
                          name="sd_v3"))


def entry_groupby_q6(device=None, n_rows: int = 1000, seed: int = 0,
                     k: int = 100):
    """(step, (table,)): db-benchmark's groupby question q6 on one device:
    ``Table.group_by(["id4", "id5"])`` of the nine-column table of
    ``example_columns_q6`` (``id1`` / ``id2`` / ``id3`` dictionary<int32,
    utf8> columns) with the median and sample sd of ``v3``; k^2 groups.
    The table is one batch, and the median's buffer covers it."""
    cols = example_columns_q6(n_rows, seed, k)
    nk = max(n_rows // k, 1)
    dicts = {}
    for name, prefix, n_values, digits in (("id1", b"id", k, 3),
                                           ("id2", b"id", k, 3),
                                           ("id3", b"id", nk, 10)):
        if n_values not in dicts:
            off, pool = numbered_strings(prefix, np.arange(1, n_values + 1),
                                         digits)
            dicts[n_values] = varlen_from_numpy(offsets=off, pool=pool,
                                                device=device)
    arrays = {}
    for name, v in cols.items():
        if name in ("id1", "id2", "id3"):
            arrays[name] = dictionary_from_numpy(
                v, dicts[nk if name == "id3" else k], device=device)
        else:
            arrays[name] = array_from_numpy(v, device=device)
    b = batch(arrays)
    aggs = q6_aggregates(b.capacity)

    def step(table_: Table) -> Table:
        return table_.group_by(list(Q6_KEYS), max_groups=max(
            1 << 16, 2 * k * k)).aggregate(list(aggs))

    return step, (Table(b.schema, [b]),)


def entry_dist_groupby_q6(device=None, n_shards: int = 4, n_rows: int = 1000,
                          seed: int = 0, k: int = 100,
                          bucket_factor: int = 2):
    """(step, (batch,)): q6 over ``n_shards`` logical shards of ``device``
    through ``DistContext.group_by``: the batch holds ``id4``, ``id5`` and
    ``v3`` (what a plan's projection leaves). The median's state is not
    row-shaped, so the rows shuffle by key (``group_by_raw_rows``, buckets
    of ``bucket_factor`` x the local capacity) and each shard aggregates
    what it received; the median's buffer covers a shard's received
    capacity. Its step returns the Table, one batch per shard."""
    device = resolve_device(device)
    cols = example_columns_q6(n_rows, seed, k)
    b = batch_from_numpy({n: cols[n] for n in Q6_KEYS + ("v3",)},
                         device=device)
    ctx = DistContext(devices=[device] * n_shards)
    local_cap = -(-b.capacity // n_shards)
    aggs = q6_aggregates(n_shards * bucket_factor * local_cap)

    def step(batch_: Batch) -> Table:
        return ctx.group_by(batch_, list(Q6_KEYS), aggs,
                            bucket_factor=bucket_factor)

    step.ctx = ctx
    return step, (b,)


def _host_column(t: Table, name: str) -> np.ndarray:
    """The values of a column of ``t`` in row order, on the host (every
    check of the dry run reads tensors: the card's machine need not have
    pyarrow for them)."""
    parts = [b.column(name).values[:len(b)].cpu().numpy() for b in t.batches]
    return np.concatenate(parts) if parts else np.zeros((0,))


def dryrun_multichip(n_shards: int = 8, device=None,
                     ctx: Optional[DistContext] = None) -> dict:
    """The JAX package's ``dryrun_multichip`` (``__graft_entry__.py``) on
    ``n_shards`` logical shards of ``device``, or over ``ctx``'s mesh
    (across processes too: every process runs the same checks on the same
    inputs), with its seeds, sizes and oracles: the distributed group-by
    (filter -> state-row exchange -> merge), the co-partitioned hash join,
    the range-partitioned sort, one hot key, and BASELINE config #5's Q3
    Declaration with ``dist=`` on both joins and the aggregate against
    pyarrow's run of the same plan. Raises AssertionError at the first
    check that fails; returns each check's Table ("group_by", "join",
    "sort", "skew", "q3") and the Q3 plan's input columns
    ("q3_columns")."""
    if ctx is None:
        device = resolve_device(device)
        ctx = DistContext(devices=[device] * n_shards)
    device, n_shards = ctx.devices[0], ctx.n

    rng = np.random.default_rng(0)
    n = 64 * n_shards
    cols = {"k": rng.integers(0, 8, n).astype(np.int64),
            "v": rng.standard_normal(n)}
    b = batch_from_numpy(cols, device=device, capacity=n)
    out = ctx.group_by(b, ["k"], [("sum", "v"), ("count_all",)],
                       max_groups_per_shard=32,
                       pre_filter=field("v") > -3.0)
    assert out.num_rows == 8, out
    totals = dict(zip(_host_column(out, "k").tolist(),
                      _host_column(out, "count_all").tolist()))
    keys, vals = cols["k"], cols["v"]
    for k in range(8):
        expect = int(((keys == k) & (vals > -3.0)).sum())
        assert totals[k] == expect, (k, totals[k], expect)

    # distributed hash join (co-partitioning shuffle + per-shard build/probe)
    rk = rng.permutation(16)[:8].astype(np.int64)
    right = batch_from_numpy({"k": rk, "rv": rng.standard_normal(8)},
                             device=device, capacity=8 * n_shards)
    jout = ctx.join(b, right, HashJoinNodeOptions(
        "inner", ["k"], ["k"], right_output=["rv"], max_build_rows=64),
        fanout_per_shard=4 * n)
    expect_rows = int(np.isin(keys, rk).sum())
    assert jout.num_rows == expect_rows, (jout.num_rows, expect_rows)

    # distributed sort (sample range partition + per-shard sort)
    sout = ctx.sort_by(b, [("v", "ascending")])
    sv = _host_column(sout, "v")
    assert bool((np.diff(sv) >= 0).all())
    assert len(sv) == n

    # skewed aggregation: every row one hot key; the state-row exchange
    # moves one row per (shard, key), so no bucket can overflow
    skew = batch_from_numpy({"k": np.zeros(n, np.int64),
                             "v": rng.standard_normal(n)},
                            device=device, capacity=n)
    sk = ctx.group_by(skew, ["k"], [("count_all",)], max_groups_per_shard=8)
    assert sk.num_rows == 1 and \
        _host_column(sk, "count_all").tolist() == [n], sk

    # BASELINE config #5's shape through the plan engine: scan -> filter ->
    # [the exchange inside the dist nodes] -> join -> join -> project ->
    # aggregate -> sort -> fetch, against pyarrow running the same plan
    nl, no, nc = 96 * n_shards, 24 * n_shards, 8 * n_shards
    li = {"l_orderkey": rng.integers(0, no, nl),
          "l_price": rng.random(nl).astype(np.float32) * 100,
          "l_disc": rng.random(nl).astype(np.float32) * 0.1,
          "l_ship": rng.integers(0, 100, nl).astype(np.int32)}
    od = {"o_orderkey": np.arange(no, dtype=np.int64),
          "o_custkey": rng.integers(0, nc, no),
          "o_date": rng.integers(0, 50, no).astype(np.int32)}
    cu = {"c_custkey": np.arange(nc, dtype=np.int64),
          "c_seg": rng.integers(0, 3, nc).astype(np.int32)}
    li_t, od_t, cu_t = (table_from_numpy(c, 64, device) for c in (li, od, cu))
    got = q3_declaration(li_t, od_t, cu_t, 256, dist=ctx).to_table()
    exp = _q3_pyarrow(li, od, cu)
    assert got.num_rows == exp.num_rows, (got.num_rows, exp.num_rows)
    assert _host_column(got, "l_orderkey").tolist() == \
        exp["l_orderkey"].to_pylist(), (got, exp.to_pydict())
    gr = _host_column(got, "revenue").astype(np.float64)
    er = np.array(exp["revenue"].to_pylist(), dtype=np.float64)
    assert np.allclose(gr, er, rtol=1e-4, atol=1e-4), (gr, er)

    print(f"dryrun_multichip({n_shards}): OK: {out.num_rows} groups, "
          f"{jout.num_rows} join rows, {len(sv)} sorted rows, skew case, "
          f"and the dist Q3 plan (scan>filter>shuffle>join>join>agg>sort>"
          f"fetch, {got.num_rows} rows) across {n_shards} logical shards of "
          f"{device}")
    return {"group_by": out, "join": jout, "sort": sout, "skew": sk,
            "q3": got, "q3_columns": (li, od, cu)}


def _q3_pyarrow(li, od, cu):
    """pyarrow's run of the Q3-shaped plan over the numpy columns: the
    dry run's oracle, as the JAX package's writes it."""
    import pyarrow as pa
    import pyarrow.compute as pc
    li, od, cu = (pa.table(c) for c in (li, od, cu))
    cu_f = cu.filter(pc.equal(cu["c_seg"], 1))
    od_f = od.filter(pc.less(od["o_date"], 25))
    li_f = li.filter(pc.greater(li["l_ship"], 40))
    oc = od_f.join(cu_f.select(["c_custkey"]), keys="o_custkey",
                   right_keys="c_custkey", join_type="inner")
    j = li_f.join(oc.select(["o_orderkey", "o_date"]),
                  keys="l_orderkey", right_keys="o_orderkey",
                  join_type="inner")
    rev = pc.multiply(j["l_price"],
                      pc.subtract(pa.scalar(1.0, pa.float32()),
                                  j["l_disc"]))
    return j.append_column("rev", rev) \
        .group_by(["l_orderkey", "o_date"]) \
        .aggregate([("rev", "sum")]) \
        .rename_columns(["l_orderkey", "o_date", "revenue"]) \
        .sort_by([("revenue", "descending"),
                  ("l_orderkey", "ascending")]).slice(0, 10)


def q13_pyarrow(source):
    """pyarrow's run of Q13 over ``entry_q13``'s ``step.source``: the
    oracle of the port's."""
    import pyarrow.compute as pc
    cu, od = source["customer"], source["orders"]
    od = od.filter(pc.invert(pc.match_substring_regex(od["o_comment"],
                                                      Q13_PATTERN)))
    j = cu.join(od.select(["o_custkey", "o_orderkey"]), keys="c_custkey",
                right_keys="o_custkey", join_type="left outer")
    cc = j.group_by("c_custkey").aggregate([("o_orderkey", "count")])
    cd = cc.group_by("o_orderkey_count").aggregate([([], "count_all")])
    return cd.select(["o_orderkey_count", "count_all"]) \
        .rename_columns(["c_count", "custdist"]) \
        .sort_by([("custdist", "descending"), ("c_count", "descending")])


def q22_pyarrow(source):
    """pyarrow's run of Q22 over ``entry_q22``'s ``step.source``
    (``is_in`` for the code set): the oracle of the port's."""
    import pyarrow as pa
    import pyarrow.compute as pc
    cu, od = source["customer"], source["orders"]
    cu = cu.append_column("cntrycode",
                          pc.utf8_slice_codeunits(cu["c_phone"], 0, 2))
    in_set = pc.is_in(cu["cntrycode"], pa.array(Q22_CODES))
    bal = cu["c_acctbal"]
    avg = pc.mean(bal.filter(pc.and_(pc.greater(bal, 0.0), in_set))).as_py()
    sel = cu.filter(pc.and_(pc.greater(bal, avg), in_set))
    anti = sel.join(od, keys="c_custkey", right_keys="o_custkey",
                    join_type="left anti")
    g = anti.group_by("cntrycode").aggregate([([], "count_all"),
                                              ("c_acctbal", "sum")])
    return g.select(["cntrycode", "count_all", "c_acctbal_sum"]) \
        .rename_columns(["cntrycode", "numcust", "totacctbal"]) \
        .sort_by([("cntrycode", "ascending")])


def q12_pyarrow(source):
    """pyarrow's run of Q12 over ``entry_q12``'s ``step.source``: the
    oracle of the port's. The CASE columns are made on orders before the
    join, and the ship mode decoded after the filter: pyarrow's join
    carries dictionary columns slowly."""
    import datetime as _dtm
    import pyarrow as pa
    import pyarrow.compute as pc
    li, od = source["lineitem"], source["orders"]
    keep = pc.and_(pc.and_(
        pc.is_in(li["l_shipmode"], pa.array(Q12_MODES)),
        pc.less(li["l_commitdate"], li["l_receiptdate"])), pc.and_(
        pc.less(li["l_shipdate"], li["l_commitdate"]), pc.and_(
            pc.greater_equal(li["l_receiptdate"],
                             pa.scalar(_dtm.date(Q12_YEAR, 1, 1))),
            pc.less(li["l_receiptdate"],
                    pa.scalar(_dtm.date(Q12_YEAR + 1, 1, 1))))))
    li = li.filter(keep)
    li = pa.table({"l_orderkey": li["l_orderkey"],
                   "l_shipmode": pc.cast(li["l_shipmode"], pa.string())})
    urgent = pc.is_in(od["o_orderpriority"], pa.array(Q12_PRIORITIES))
    od = pa.table({"o_orderkey": od["o_orderkey"],
                   "high": pc.cast(urgent, pa.int64()),
                   "low": pc.cast(pc.invert(urgent), pa.int64())})
    g = li.join(od, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner") \
        .group_by("l_shipmode").aggregate([("high", "sum"), ("low", "sum")])
    return g.select(["l_shipmode", "high_sum", "low_sum"]) \
        .rename_columns(["l_shipmode", "high_line_count",
                         "low_line_count"]) \
        .sort_by([("l_shipmode", "ascending")])


def q7_pyarrow(source):
    """pyarrow's run of Q7 over ``entry_q7``'s ``step.source``: the oracle
    of the port's."""
    import datetime as _dtm
    import pyarrow as pa
    import pyarrow.compute as pc
    na = source["nation"]
    na = na.filter(pc.is_in(na["n_name"], pa.array(Q7_NATIONS)))
    supp = source["supplier"].join(
        na.rename_columns(["s_nk", "supp_nation"]), keys="s_nationkey",
        right_keys="s_nk").select(["s_suppkey", "supp_nation"])
    cust = source["customer"].join(
        na.rename_columns(["c_nk", "cust_nation"]), keys="c_nationkey",
        right_keys="c_nk").select(["c_custkey", "cust_nation"])
    ords = source["orders"].join(cust, keys="o_custkey",
                                 right_keys="c_custkey") \
        .select(["o_orderkey", "cust_nation"])
    li = source["lineitem"]
    d = li["l_shipdate"]
    li = li.filter(pc.and_(
        pc.greater_equal(d, pa.scalar(_dtm.date(1995, 1, 1))),
        pc.less_equal(d, pa.scalar(_dtm.date(1996, 12, 31)))))
    j = li.join(supp, keys="l_suppkey", right_keys="s_suppkey") \
        .join(ords, keys="l_orderkey", right_keys="o_orderkey")
    a, b = Q7_NATIONS
    sn, cn = j["supp_nation"], j["cust_nation"]
    pair = pc.or_(pc.and_(pc.equal(sn, a), pc.equal(cn, b)),
                  pc.and_(pc.equal(sn, b), pc.equal(cn, a)))
    j = j.filter(pair)
    vol = pc.multiply(j["l_extendedprice"],
                      pc.subtract(1.0, j["l_discount"]))
    t = pa.table({"supp_nation": j["supp_nation"],
                  "cust_nation": j["cust_nation"],
                  "l_year": pc.year(j["l_shipdate"]), "volume": vol})
    g = t.group_by(["supp_nation", "cust_nation", "l_year"]) \
        .aggregate([("volume", "sum")])
    return g.rename_columns(["supp_nation", "cust_nation", "l_year",
                             "revenue"]) \
        .sort_by([("supp_nation", "ascending"),
                  ("cust_nation", "ascending"), ("l_year", "ascending")])


def host_boundary_numpy(n_rows: int, seed: int):
    """The oracle of ``entry_host_boundary``: Python ``re`` over the 4,096
    words, indexed by the rows' codes: (the kept rows' mask, their v)."""
    import re
    codes, v = example_columns_host_boundary(n_rows, seed)
    rx = re.compile(HB_PATTERN)
    keep = np.array([rx.search(w) is not None for w in HB_WORDS])[codes]
    return keep, v[keep]


def wordcount_pyarrow(source):
    """pyarrow's word count over ``entry_wordcount``'s ``step.source``:
    ``utf8_split_whitespace`` -> ``list_flatten`` -> count by word; the
    oracle of the port's."""
    import pyarrow as pa
    import pyarrow.compute as pc
    words = pc.list_flatten(pc.utf8_split_whitespace(
        source["orders"]["o_comment"]))
    g = pa.table({"word": words}).group_by("word").aggregate(
        [([], "count_all")])
    return g.rename_columns(["word", "count"]).sort_by(
        [("count", "descending"), ("word", "ascending")])


def baskets_numpy(source) -> dict:
    """numpy's order baskets over ``entry_baskets``' ``step.source``: the
    generator emits lineitem by order, so each basket is a run of
    l_orderkey (``np.unique`` counts give the offsets) and l_linenumber
    places each quantity. The dict ``baskets_arrays`` gives of the port's
    Table."""
    li = source["lineitem"]
    okey = li["l_orderkey"].to_numpy()
    part = li["l_partkey"].to_numpy()
    line = li["l_linenumber"].to_numpy()
    qty = li["l_quantity"].to_numpy()
    if okey.size and not (okey[1:] >= okey[:-1]).all():
        raise ValueError("lineitem is not ordered by l_orderkey")
    # sorted: the runs start where the key changes
    starts = np.flatnonzero(np.concatenate([[True], okey[1:] != okey[:-1]]))
    counts = np.diff(np.append(starts, okey.size))
    keys = okey[starts]
    keep = counts >= BASKET_MIN_PARTS
    k, st, n = keys[keep], starts[keep], counts[keep]
    rows = np.repeat(st, n) + (np.arange(int(n.sum())) -
                               np.repeat(np.cumsum(n) - n, n))
    top = np.minimum(n, 3)
    top_rows = np.repeat(st, top) + (np.arange(int(top.sum())) -
                                     np.repeat(np.cumsum(top) - top, top))
    out = {"l_orderkey": k, "n": n.astype(np.int32),
           "parts_offsets": np.concatenate([[0], np.cumsum(n)]),
           "parts": part[rows], "first": part[st],
           "top3_offsets": np.concatenate([[0], np.cumsum(top)]),
           "top3": part[top_rows]}
    # each quantity at its basket and line number
    basket = np.repeat(np.arange(len(k)), n)
    ln = line[rows] - 1
    for j, name in enumerate(BASKET_LINES):
        at = ln == j
        v = np.zeros(len(k))
        ok = np.zeros(len(k), bool)
        v[basket[at]] = qty[rows[at]]
        ok[basket[at]] = True
        out[f"qty_{name}"], out[f"qty_{name}_valid"] = v, ok
    out["q1"], out["q1_valid"] = out["qty_1"], out["qty_1_valid"]
    return out


def baskets_arrays(table: Table) -> dict:
    """The port's baskets Table as ``baskets_numpy``'s dict (its rows
    ordered by l_orderkey; the values of null slots zeroed)."""
    cols = {}
    batches = [x.to("cpu") for x in table.batches]
    n_rows = [int(x.length) for x in batches]

    def flat(name):
        vals, ok = [], []
        for x, n in zip(batches, n_rows):
            a = x.column(name)
            vals.append(a.values[:n].numpy())
            ok.append(a.validity_or_true()[:n].numpy())
        return np.concatenate(vals), np.concatenate(ok)

    def lists(name):
        offs, vals, base = [np.zeros(1, np.int64)], [], 0
        for x, n in zip(batches, n_rows):
            a = x.column(name)
            off = a.offsets[:n + 1].numpy().astype(np.int64)
            vals.append(a.dictionary.values[off[0]:off[-1]].numpy())
            offs.append(off[1:] - off[0] + base)
            base += int(off[-1] - off[0])
        return np.concatenate(offs), np.concatenate(vals)

    okey, _ = flat("l_orderkey")
    order = np.argsort(okey, kind="stable")
    cols["l_orderkey"] = okey[order]
    cols["n"] = flat("n")[0][order]
    cols["first"] = flat("first")[0][order]
    for name in ("parts", "top3"):
        off, vals = lists(name)
        lens = np.diff(off)[order]
        starts = off[:-1][order]
        idx = np.repeat(starts, lens) + (np.arange(int(lens.sum())) -
                                         np.repeat(np.cumsum(lens) - lens,
                                                   lens))
        cols[f"{name}_offsets"] = np.concatenate([[0], np.cumsum(lens)])
        cols[name] = vals[idx]
    for j, name in enumerate(BASKET_LINES):
        vals, ok = [], []
        for x, n in zip(batches, n_rows):
            c = x.column("qty").children[j]
            vals.append(c.values[:n].numpy())
            ok.append(c.validity_or_true()[:n].numpy())
        v, ok = np.concatenate(vals)[order], np.concatenate(ok)[order]
        cols[f"qty_{name}"], cols[f"qty_{name}_valid"] = \
            np.where(ok, v, 0.0), ok
    q1, q1_ok = flat("q1")
    cols["q1"], cols["q1_valid"] = np.where(q1_ok, q1, 0.0)[order], \
        q1_ok[order]
    return cols


def baskets_differ(got: dict, want: dict) -> list:
    """The keys of two ``baskets_numpy`` dicts whose arrays differ."""
    return [k for k in want if k not in got or got[k].shape != want[k].shape
            or not np.array_equal(got[k], want[k])]


def ree_runs_numpy(keys: np.ndarray) -> np.ndarray:
    """The run ends of a key column (rows where the next key differs, and
    the last)."""
    if keys.size == 0:
        return keys.astype(np.int64)
    return np.concatenate([np.flatnonzero(keys[1:] != keys[:-1]) + 1,
                           [keys.size]])


# ---- the A7c sweep: the nested layouts and their functions ----------------

A7C_TENSOR_N = 4096         # square sparse matrices of the sweep
A7C_TENSOR_DENSITY = 0.01
A7C_TENSOR_COLS = 64        # columns of the dense right-hand side of mm
A7C_GROUPS = 1024           # hash_list's groups
A7C_LAYOUTS = ("lists", "fixed_size_list", "map", "struct", "sparse_union",
               "dense_union")
A7C_REGEX = r"(?P<w>[a-z]+) (?P<x>[a-z]+)"


def a7c_sweep_columns(n_rows: int, seed: int, comments, device=None) -> dict:
    """The A7c sweep's inputs on ``device``, made from ``seed`` (pyarrow
    builds them on the host, imported here): ``comments`` (a string
    array), lists of int64 (0-7 elements, one row in 97 null; ``lists1``
    never empty), a fixed-size list, a map<string, int64>, a struct, a
    sparse and a dense union, group keys and values, pivot keys (one per
    (row // 7, row % 7); and "1".."7" then "0", which pivot_wider
    ignores), sorted runs, a mask and take indices; the
    sparse matrix (COO, CSR, CSC of a 4096 x 4096 at 1 %) and the dense
    right-hand sides."""
    import pyarrow as pa
    from .core.interop import array_from_pyarrow
    from .core.tensor import SparseCOOTensor, SparseCSCMatrix, \
        SparseCSRMatrix
    rng = np.random.default_rng(seed)
    n = n_rows
    null = np.arange(n) % 97 == 5

    def lists(lo):
        lens = rng.integers(lo, 8, n)
        off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        vals = pa.array(rng.integers(-1000, 1000, int(off[-1])))
        return pa.ListArray.from_arrays(pa.array(off), vals,
                                        mask=pa.array(null))

    ints = pa.array(rng.integers(0, 1 << 40, n), mask=null)
    strs = pa.array(np.char.add("s", rng.integers(0, 999, n).astype(str)))
    keys = np.char.add("k", rng.integers(0, 10, 3 * n).astype(str))
    moff = np.concatenate([[0], np.cumsum(rng.integers(0, 4, n))])
    mp = pa.MapArray.from_arrays(pa.array(moff.astype(np.int32)),
                                 pa.array(keys[:moff[-1]]),
                                 pa.array(rng.integers(0, 99, moff[-1])))
    codes = pa.array(rng.integers(0, 2, n).astype(np.int8))
    cnp = codes.to_numpy()
    dense_off = np.where(cnp == 0, np.cumsum(cnp == 0) - 1,
                         np.cumsum(cnp == 1) - 1).astype(np.int32)
    words = np.char.add("w", rng.integers(0, 50, 4 * n).astype(str))
    woff = np.concatenate([[0], np.cumsum(rng.integers(0, 5, n))])
    host = {
        "comments": pa.array(comments),
        "lists": lists(0), "lists1": lists(1),
        "fixed_size_list": pa.FixedSizeListArray.from_arrays(
            pa.array(rng.integers(0, 100, 2 * n)), 2),
        "map": mp,
        "struct": pa.StructArray.from_arrays([ints, strs], ["a", "b"]),
        "sparse_union": pa.UnionArray.from_sparse(codes, [ints, strs]),
        "dense_union": pa.UnionArray.from_dense(
            codes, pa.array(dense_off), [ints, strs]),
        "ints": ints, "strs": strs,
        "words": pa.ListArray.from_arrays(
            pa.array(woff.astype(np.int32)), pa.array(words[:woff[-1]])),
        "gkey": pa.array(rng.integers(0, A7C_GROUPS, n)),
        "gval": pa.array(rng.normal(size=n), mask=null),
        "pgroup": pa.array(np.arange(n) // 7),
        "pkey": pa.array((np.arange(n) % 7 + 1).astype(str)),
        "pkey1": pa.array(np.where(np.arange(n) < 7, np.arange(n) + 1,
                                   0).astype(str)),
        "runs": pa.array(np.repeat(rng.integers(0, 50, n),
                                   rng.integers(1, 9, n))[:n]),
        "mask": pa.array(rng.random(n) < 0.5, mask=null),
        "indices": pa.array(rng.integers(0, n, n).astype(np.int32)),
    }
    cols = {k: array_from_pyarrow(v, device=device) for k, v in host.items()}
    m = np.where(rng.random((A7C_TENSOR_N, A7C_TENSOR_N))
                 < A7C_TENSOR_DENSITY,
                 rng.normal(size=(A7C_TENSOR_N, A7C_TENSOR_N)), 0.0)
    cols["dense"] = m
    cols["coo"] = SparseCOOTensor.from_dense(m, device=device)
    cols["csr"] = SparseCSRMatrix.from_dense(m, device=device)
    cols["csc"] = SparseCSCMatrix.from_dense(m, device=device)
    cols["x"] = rng.normal(size=A7C_TENSOR_N)
    cols["y"] = rng.normal(size=(A7C_TENSOR_N, A7C_TENSOR_COLS))
    return cols


def _a7c_entries():
    """(label, host hop?, tolerance, fn(cols) -> result) of the A7c sweep:
    the 19 functions, take / filter / concat of each nested layout (a
    union's concat raises: no entry),
    hash_list and hash_pivot_wider through ``Table.group_by``, the
    pivot_longer node, and the tensors' to_dense / mv / mm."""
    from types import SimpleNamespace

    from .compute import call_function as cf
    from .ops import nested, ree, strings_regex as sr
    from .ops.agg_options import PivotWiderOptions
    from .ops.concat import concat_arrays
    from .ops.selection import filter_array, take_array

    def fn(name, *names, options=None, **kw):
        return lambda c: cf(name, [c[x] if isinstance(x, str) and x in c
                                   else x for x in names],
                            options=options, **kw)

    def table(c, names):
        from .core.schema import Field, Schema
        arrays = [c[x] for x in names]
        return Table(Schema(tuple(Field(x, a.type, True)
                                  for x, a in zip(names, arrays))),
                     [Batch(Schema(tuple(Field(x, a.type, True)
                                         for x, a in zip(names, arrays))),
                            arrays, arrays[0].length)])

    def group_list(c):
        return table(c, ["gkey", "gval"]).group_by(
            "gkey", max_groups=A7C_GROUPS).aggregate([AggregateSpec(
                "hash_list", "gval", SimpleNamespace(
                    buffer_rows=_pow2_at_least(c["gval"].capacity)),
                "gval_list")])

    def group_pivot(c):
        t = table(c, ["pgroup", "pkey", "gval"])
        return t.group_by("pgroup", max_groups=_pow2_at_least(
            c["pgroup"].capacity // 7 + 1)).aggregate(
            [(("pkey", "gval"), "pivot_wider",
              PivotWiderOptions(list(BASKET_LINES)))])

    def pivot_longer(c):
        from .acero import Declaration, PivotLongerNodeOptions, \
            TableSourceNodeOptions
        return Declaration.from_sequence([
            Declaration("table_source", TableSourceNodeOptions(
                table(c, ["ints", "gval", "gkey"]))),
            Declaration("pivot_longer", PivotLongerNodeOptions(
                ["which"], ["x"], [(["ints"], ["ints"]),
                                   (["gkey"], ["gkey"])]))]).to_table()

    e = [("list_value_length", False, None, fn("list_value_length",
                                                "lists")),
         ("list_parent_indices", False, None, fn("list_parent_indices",
                                                  "lists")),
         ("list_flatten", False, None, fn("list_flatten", "lists")),
         ("list_element", False, None, fn("list_element", "lists1", 0)),
         ("list_slice", False, None, fn(
             "list_slice", "lists", options=nested.ListSliceOptions(1, 6,
                                                                    2))),
         ("make_struct", False, None, fn(
             "make_struct", "ints", "strs",
             options=nested.MakeStructOptions(["a", "b"]))),
         ("struct_field", False, None, fn(
             "struct_field", "struct",
             options=nested.StructFieldOptions(name="b")))]
    for occ in ("first", "last", "all"):
        e.append((f"map_lookup:{occ}", False, None, fn(
            "map_lookup", "map",
            options=nested.MapLookupOptions("k3", occ))))
    e += [("split_pattern", False, None, fn(
              "split_pattern", "comments",
              options=sr.SplitPatternOptions(" "))),
          ("split_pattern:reverse", False, None, fn(
              "split_pattern", "comments",
              options=sr.SplitPatternOptions("e", 2, True))),
          ("utf8_split_whitespace", False, None, fn(
              "utf8_split_whitespace", "comments")),
          ("ascii_split_whitespace", False, None, fn(
              "ascii_split_whitespace", "comments")),
          ("split_pattern_regex", True, None, fn(
              "split_pattern_regex", "comments",
              options=sr.SplitPatternOptions(r"\s+"))),
          ("extract_regex", True, None, fn(
              "extract_regex", "comments",
              options=sr.ExtractRegexOptions(A7C_REGEX))),
          ("extract_regex_span", True, None, fn(
              "extract_regex_span", "comments",
              options=sr.ExtractRegexOptions(A7C_REGEX))),
          ("binary_join", False, None, fn("binary_join", "words", " ")),
          ("run_end_encode", False, None, fn("run_end_encode", "runs")),
          ("run_end_decode", False, None, lambda c: cf(
              "run_end_decode", [ree.run_end_encode_array(c["runs"])])),
          ("random", False, "random", lambda c: cf(
              "random", [], options=ree.RandomOptions(
                  c["runs"].capacity, 7, c["runs"].device))),
          ("pivot_wider", False, None, lambda c: cf(
              "pivot_wider", [c["pkey1"], c["gval"]],
              options=PivotWiderOptions(list(BASKET_LINES),
                                        "ignore")).as_py())]
    for lay in A7C_LAYOUTS:
        e += [(f"take:{lay}", False, None,
               lambda c, lay=lay: take_array(c[lay], c["indices"])),
              (f"filter:{lay}", False, None,
               lambda c, lay=lay: filter_array(c[lay], c["mask"]))]
        if "union" not in lay:      # a union's concat raises
            e.append((f"concat:{lay}", False, None,
                      lambda c, lay=lay: concat_arrays([c[lay], c[lay]])))
    e += [("hash_list", False, None, group_list),
          ("hash_pivot_wider", False, None, group_pivot),
          ("pivot_longer", False, None, pivot_longer)]
    for kind in ("coo", "csr", "csc"):
        e += [(f"{kind}:to_dense", False, None,
               lambda c, k=kind: c[k].to_dense()),
              (f"{kind}:mv", False, "product",
               lambda c, k=kind: c[k].mv(c["x"])),
              (f"{kind}:mm", False, "product",
               lambda c, k=kind: c[k].mm(c["y"]))]
    return e


A7C_SWEEP = _a7c_entries()


def nested_parts(a) -> list:
    """An A7c sweep result as it is compared, as bytes on the host: a
    Table's or Batch's rows ordered by its first column, then for each
    Array its length and validity and a list's offsets and child (over
    the used child rows), a struct's or union's children (a union's codes
    and value offsets), a varlen column's offsets and used bytes, a
    fixed-width column's valid values; a tensor's values; anything else
    as its repr."""
    import torch
    from .ops.selection import take_batch
    from .core import datatype as _dt
    from .core.array import Array
    from .ops.concat import concat_batches
    if isinstance(a, Table):
        a = concat_batches([b.to("cpu").with_length(int(b.length))
                            for b in a.batches])
    if isinstance(a, Batch):
        b = a.to("cpu")
        n = int(b.length)
        order = torch.argsort(b.column(0).values[:n], stable=True)
        b = take_batch(b, Array(_dt.int32, order.to(torch.int32), length=n))
        return [p for c in b.arrays for p in nested_parts(c)]
    if isinstance(a, torch.Tensor):
        return [a.cpu().numpy().tobytes()]
    if not hasattr(a, "type"):
        return [repr(a).encode()]
    n = int(a.length)
    ok = a.validity_or_true()[:n].cpu()
    parts = [np.array([n], np.int64).tobytes(), ok.numpy().tobytes()]
    t = a.type
    if isinstance(t, _dt.ListType):
        off = a.offsets[:n + 1].cpu()
        used = int(off[-1]) if n else 0
        return parts + [off.numpy().tobytes()] + \
            nested_parts(a.dictionary.with_length(used))
    if isinstance(t, _dt.UnionType):
        parts.append(a.values[:n].cpu().numpy().tobytes())
        if t.mode == "dense":
            parts.append(a.offsets[:n].cpu().numpy().tobytes())
            return parts + [p for c in a.children for p in nested_parts(c)]
        return parts + [p for c in a.children
                        for p in nested_parts(c.with_length(n))]
    if isinstance(t, _dt.StructType):
        return parts + [p for c in a.children
                        for p in nested_parts(c.with_length(n))]
    if a.offsets is not None:       # varlen; a run-end array's run ends
        off = a.offsets[:n + 1].cpu()
        parts.append(off.numpy().tobytes())
        if t.is_varlen:
            return parts + [a.values[:int(off[-1])].cpu().numpy().tobytes()]
    from .ops.bits import as_signed_bits
    return parts + [str(t).encode(),
                    as_signed_bits(a.values[:n]).cpu()[ok].numpy().tobytes()]


def a7c_product_scale(entry_label: str, cols: dict) -> np.ndarray:
    """|A| @ |x| (or |y|) of a product entry, on the host: the scale of its
    float64 tolerance."""
    rhs = cols["x"] if entry_label.endswith(":mv") else cols["y"]
    return np.abs(cols["dense"]) @ np.abs(rhs)


# ---- the ordered plan nodes and the decimal columns (A7d, A10) -------------

SMERGE_COLUMNS = {"lineitem": ["l_orderkey", "l_linenumber", "l_shipdate",
                               "l_extendedprice", "l_shipmode"]}
SMERGE_KEYS = (("l_shipdate", "ascending"), ("l_orderkey", "ascending"),
               ("l_linenumber", "ascending"))
Q1_SHIPDATE = (1998, 9, 2)          # TPC-H Q1's date - 90 days
DECIMAL_Q1_COLUMNS = {"lineitem": ["l_orderkey", "l_shipdate",
                                   "l_returnflag", "l_linestatus",
                                   "l_quantity", "l_extendedprice",
                                   "l_discount", "l_tax"]}
# the TPC-H spec's DECIMAL(15,2) columns; l_extendedprice also at (38, 2)
DECIMAL_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
DECIMAL_WIDE = "l_extendedprice_w"
DECIMAL_PRICE_FLOOR = "50000.00"
ASOF_QUOTE_GAP = 468_000            # ns; 100M quotes span 6.5 hours
ASOF_SYMBOLS = 8192


def _row_slices(b: Batch, rows: int) -> list:
    """A batch of flat and dictionary columns as batches of at most
    ``rows`` rows: views of its buffers, its dictionaries shared."""
    n = int(b.length)
    out = []
    for s in range(0, n, rows):
        e = min(s + rows, n)
        out.append(Batch(b.schema, [
            Array(a.type, a.values[s:e], None if a.validity is None
                  else a.validity[s:e], length=e - s,
                  dictionary=a.dictionary) for a in b.arrays], e - s))
    return out


def entry_sorted_merge(device=None, scale_factor: float = 0.01,
                       seed: int = 42, n_sources: int = 8,
                       max_batch_rows: int = 1 << 22, source=None):
    """(step, sources): a merge of ordered partitions, as Acero's
    ``sorted_merge`` merges ordered fragments. The port's TPC-H lineitem
    (``SMERGE_COLUMNS``; or ``source``) is cut into ``n_sources`` sources
    by ``l_orderkey`` range, like files; each source is sorted by
    ``SMERGE_KEYS`` on the device (set-up) and cut into batches of
    ``max_batch_rows`` rows. step(*sources) -> the Table of the plan
    ``sorted_merge`` over one ``table_source`` a source.
    ``step.source`` holds the pyarrow table (``sorted_merge_differ``'s
    input)."""
    from .acero import Declaration, SortedMergeNodeOptions, \
        TableSourceNodeOptions
    from .utils.tpch import tpch_table
    cols = SMERGE_COLUMNS["lineitem"]
    src = source["lineitem"].select(cols) if source else \
        tpch_table("lineitem", scale_factor, seed, columns=cols)
    okey = src["l_orderkey"].to_numpy()
    edges = np.searchsorted(okey, np.linspace(okey[0], okey[-1] + 1,
                                              n_sources + 1))
    sort = SortOptions(list(SMERGE_KEYS))
    tables = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        part = Table.from_pyarrow(src.slice(lo, hi - lo),
                                  max_rows_per_batch=max(hi - lo, 1),
                                  device=device)
        b = part.batches[0]
        b = take_batch(b, sort_indices_batch(b, sort))
        tables.append(Table(b.schema, _row_slices(b, max_batch_rows)))

    def step(*parts: Table) -> Table:
        return Declaration("sorted_merge", SortedMergeNodeOptions(
            list(SMERGE_KEYS)), [
            Declaration("table_source", TableSourceNodeOptions(t))
            for t in parts]).to_table()

    step.source = {"lineitem": src}
    return step, tuple(tables)


def _host_values(t: Table, name: str) -> np.ndarray:
    """A column's values over the table's batches, on the host."""
    return np.concatenate([b.column(name).values[:int(b.length)].cpu()
                           .numpy() for b in t.batches]) if t.batches \
        else np.zeros((0,))


def sorted_merge_differ(out: Table, source) -> list:
    """What of a merged lineitem differs from its input (empty when it is
    right): the key tuples non-decreasing; the ids ``l_orderkey * 8 +
    l_linenumber`` a permutation of the input's (the input is generated in
    id order, so an order's first row and the line number map each output
    row to its input row, and its id must be that row's); every payload
    its input row's, the dictionary decoded."""
    src = source["lineitem"]
    bad = []
    sd, ok, ln = (_host_values(out, c) for c in ("l_shipdate", "l_orderkey",
                                                  "l_linenumber"))
    d0, d1, d2 = np.diff(sd), np.diff(ok), np.diff(ln)
    if not np.all((d0 > 0) | ((d0 == 0) & ((d1 > 0) | ((d1 == 0) &
                                                      (d2 >= 0))))):
        bad.append("order")
    in_ok = src["l_orderkey"].to_numpy()
    in_ids = in_ok * 8 + src["l_linenumber"].to_numpy()
    ids = ok * 8 + ln
    # the input is in id order: an order's rows start at its first row,
    # line number 1 first (a table by order key in place of a search)
    first = np.flatnonzero(np.diff(in_ok, prepend=in_ok[:1] - 1))
    row_of = np.full(int(in_ok[-1]) + 2, -1, np.int64)
    row_of[in_ok[first]] = first
    pos = np.clip(row_of[np.clip(ok, 0, len(row_of) - 1)] + ln - 1, 0,
                  len(in_ids) - 1)
    seen = np.zeros(len(in_ids), bool)
    seen[pos] = True
    if len(ids) != len(in_ids) or not np.array_equal(in_ids[pos], ids) \
            or not seen.all():
        bad.append("ids")
    if not np.array_equal(_host_values(out, "l_extendedprice"),
                          src["l_extendedprice"].to_numpy()[pos]) or \
            not np.array_equal(sd, src["l_shipdate"].cast("int32")
                               .to_numpy()[pos]):
        bad.append("payload")
    mode = src["l_shipmode"].combine_chunks()
    vocab = mode.dictionary.to_pylist()
    for b in out.batches:
        col = b.column("l_shipmode")
        d = col.dictionary
        words = [bytes(d.values[int(d.offsets[i]):int(d.offsets[i + 1])]
                       .cpu().numpy()).decode() for i in range(len(d))]
        if any(w not in vocab for w in words):
            bad.append("dictionary")
            break
    else:
        codes = np.concatenate([b.column("l_shipmode").values[
            :int(b.length)].cpu().numpy() for b in out.batches])
        d = out.batches[0].column("l_shipmode").dictionary
        words = [bytes(d.values[int(d.offsets[i]):int(d.offsets[i + 1])]
                       .cpu().numpy()).decode() for i in range(len(d))]
        to_src = np.array([vocab.index(w) for w in words])
        if not np.array_equal(to_src[codes],
                              mode.indices.to_numpy()[pos]):
            bad.append("l_shipmode")
    return bad


def example_columns_asof(n_quotes: int, n_trades: int, seed: int,
                         n_symbols: int = ASOF_SYMBOLS):
    """A trading session's quotes and trades, made with numpy from
    ``seed``: quotes ``ts`` (int64 ns, non-decreasing, gaps uniform in
    [0, ``ASOF_QUOTE_GAP``), so equal times occur), ``sym`` uniform over
    ``n_symbols``, ``bid`` / ``ask`` float64; trades ``ts`` over the same
    span (gaps uniform), ``sym``, ``price`` float64, ``size`` int64."""
    rng = np.random.default_rng(seed)
    q_ts = np.cumsum(rng.integers(0, ASOF_QUOTE_GAP, n_quotes))
    bid = np.round(rng.random(n_quotes) * 500 + 1, 2)
    quotes = {"ts": q_ts, "sym": rng.integers(0, n_symbols, n_quotes),
              "bid": bid, "ask": bid + np.round(rng.random(n_quotes), 2)}
    gap = max(2 * int(q_ts[-1]) // max(n_trades, 1), 1)
    trades = {"ts": np.cumsum(rng.integers(0, gap, n_trades)),
              "sym": rng.integers(0, n_symbols, n_trades),
              "price": np.round(rng.random(n_trades) * 500 + 1, 2),
              "size": rng.integers(1, 1000, n_trades)}
    return quotes, trades


def asof_declaration(trades: Table, quotes: Table, tolerance: int):
    """``asofjoin`` of trades (left) and quotes (right) on ``ts`` by
    ``sym``: each trade with the latest quote of its symbol at most
    ``|tolerance|`` ns older (tolerance >= 0: the earliest at most that
    much newer)."""
    from .acero import AsofJoinNodeOptions, Declaration, \
        TableSourceNodeOptions
    return Declaration("asofjoin", AsofJoinNodeOptions(
        "ts", ["sym"], "ts", ["sym"], tolerance), [
        Declaration("table_source", TableSourceNodeOptions(trades)),
        Declaration("table_source", TableSourceNodeOptions(quotes))])


def entry_asof(device=None, n_quotes: int = 1 << 16, n_trades: int = 1 << 14,
               seed: int = 0, tolerance: int = -1_000_000_000,
               max_batch_rows: int = 1 << 22):
    """(step, (trades, quotes)): the trades-and-quotes as-of join of
    kdb+ and pandas ``merge_asof`` users over ``example_columns_asof``'s
    session, staged in batches of ``max_batch_rows`` rows:
    step(trades, quotes) -> the trades with the matched quote's bid and
    ask (``asof_declaration``). ``step.columns`` holds the numpy columns
    (``asof_numpy``'s input)."""
    quotes, trades = example_columns_asof(n_quotes, n_trades, seed)
    q = table_from_numpy(quotes, max_batch_rows, device)
    t = table_from_numpy(trades, max_batch_rows, device)

    def step(trades_t: Table, quotes_t: Table) -> Table:
        return asof_declaration(trades_t, quotes_t, tolerance).to_table()

    step.columns = (quotes, trades)
    return step, (t, q)


def asof_numpy(quotes, trades, tolerance: int) -> np.ndarray:
    """Each trade's matched quote row (-1 for none): a stable argsort of
    the quotes' combined key ``sym << 45 | ts`` (a stable sort by ``sym``
    keeps their time order), then per trade ``searchsorted(side="right")
    - 1``, the same symbol and the tolerance: the later quote of a tie
    wins. A tolerance >= 0 takes the first quote at or after the trade
    (``side="left"``), and among the quotes of that time the last in
    input order."""
    def by_symbol(sym):
        # a stable sort by symbol keeps the time order (a radix sort of
        # 16-bit symbols)
        return np.argsort(sym.astype(np.int16 if ASOF_SYMBOLS <= 1 << 15
                                     else np.int64), kind="stable")
    sym = quotes["sym"]
    perm = by_symbol(sym)
    keys = (sym[perm] << 45) | quotes["ts"][perm]
    # the trades' keys searched in their order, which keeps each search
    # near the last
    tperm = by_symbol(trades["sym"])
    tsym = trades["sym"][tperm]
    tts = trades["ts"][tperm]
    tkey = (tsym << 45) | tts
    n = len(keys)
    if tolerance < 0:
        pos = np.searchsorted(keys, tkey, side="right") - 1
        pc = np.clip(pos, 0, max(n - 1, 0))
        ok = (pos >= 0) & (keys[pc] >> 45 == tsym) & \
            (tts - (keys[pc] & ((1 << 45) - 1)) <= -tolerance)
    else:
        pos = np.searchsorted(keys, tkey, side="left")
        pc = np.clip(pos, 0, max(n - 1, 0))
        ok = (pos < n) & (keys[pc] >> 45 == tsym) & \
            ((keys[pc] & ((1 << 45) - 1)) - tts <= tolerance)
        pc = np.searchsorted(keys, keys[pc], side="right") - 1
    out = np.empty(len(tkey), np.int64)
    out[tperm] = np.where(ok, perm[pc], -1)
    return out


def asof_differ(out: Table, quotes, match: np.ndarray) -> list:
    """What of the join's output differs from ``asof_numpy``'s matches
    (empty when it is right): the matched bid and ask exact, and the
    nulls."""
    bad = []
    hit = match >= 0
    for name in ("bid", "ask"):
        got = _host_values(out, name)
        valid = np.concatenate([
            b.column(name).validity_or_true()[:int(b.length)].cpu().numpy()
            for b in out.batches])
        if len(got) != len(match) or not np.array_equal(valid, hit) or \
                not np.array_equal(got[hit], quotes[name][match[hit]]):
            bad.append(name)
    return bad


Q1_COLUMNS = ["l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax", "l_shipdate"]


def tpch_gen_q1_declaration(scale_factor: float, seed: int,
                            max_batch_rows: int, device=None):
    """TPC-H Q1 (clause 2.4.1) over the plan's own generator: ``tpch_gen``
    lineitem -> ``l_shipdate <= 1998-09-02`` -> disc_price and charge ->
    by (l_returnflag, l_linestatus): the sums of l_quantity,
    l_extendedprice, disc_price and charge, the means of l_quantity,
    l_extendedprice and l_discount, count_all -> ordered by the keys (the
    generator's float columns)."""
    import datetime as _dtm
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, OrderByNodeOptions,
                        ProjectNodeOptions, TpchGenNodeOptions)
    from .compute.expressions import literal
    price = field("l_extendedprice")
    disc_price = price * (literal(1.0) - field("l_discount"))
    keys = ["l_returnflag", "l_linestatus"]
    return Declaration.from_sequence([
        Declaration("tpch_gen", TpchGenNodeOptions(
            "lineitem", scale_factor, seed, max_batch_rows, device)),
        Declaration("filter", FilterNodeOptions(
            field("l_shipdate") <= literal(_dtm.date(*Q1_SHIPDATE)))),
        Declaration("project", ProjectNodeOptions(
            [field(k) for k in keys] + [
                field("l_quantity"), price, disc_price,
                disc_price * (literal(1.0) + field("l_tax")),
                field("l_discount")],
            keys + ["l_quantity", "l_extendedprice", "disc_price",
                    "charge", "l_discount"])),
        Declaration("aggregate", AggregateNodeOptions([
            AggregateSpec("sum", "l_quantity", name="sum_qty"),
            AggregateSpec("sum", "l_extendedprice", name="sum_base_price"),
            AggregateSpec("sum", "disc_price", name="sum_disc_price"),
            AggregateSpec("sum", "charge", name="sum_charge"),
            AggregateSpec("mean", "l_quantity", name="avg_qty"),
            AggregateSpec("mean", "l_extendedprice", name="avg_price"),
            AggregateSpec("mean", "l_discount", name="avg_disc"),
            AggregateSpec("count_all", name="count_order")],
            keys=keys, max_groups=16)),
        Declaration("order_by", OrderByNodeOptions(
            [(k, "ascending") for k in keys])),
    ])


def entry_tpch_gen_q1(device=None, scale_factor: float = 0.01,
                      seed: int = 42, max_batch_rows: int = 1 << 22):
    """(step, ()): step() -> the Table of ``tpch_gen_q1_declaration``:
    the generator runs inside the plan, on the host, on each call (its
    projection pushdown generates Q1's seven columns)."""
    def step() -> Table:
        return tpch_gen_q1_declaration(scale_factor, seed, max_batch_rows,
                                       device).to_table()
    return step, ()


def q1_numpy(lineitem) -> dict:
    """TPC-H Q1 over a pyarrow lineitem in numpy: the (returnflag,
    linestatus) groups in key order, each group's sums, means and count
    (float64)."""
    import datetime as _dtm
    keep = lineitem["l_shipdate"].cast("int32").to_numpy() <= \
        (_dtm.date(*Q1_SHIPDATE) - _dtm.date(1970, 1, 1)).days
    groups, gid = _q1_groups(lineitem, keep)
    q, p, d, t = (lineitem[c].to_numpy()[keep] for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp = p * (1.0 - d)

    def s(x):
        return np.bincount(gid, weights=x, minlength=len(groups))
    cnt = np.bincount(gid, minlength=len(groups))
    return {"l_returnflag": [g[0] for g in groups],
            "l_linestatus": [g[1] for g in groups],
            "sum_qty": s(q), "sum_base_price": s(p), "sum_disc_price": s(dp),
            "sum_charge": s(dp * (1.0 + t)), "avg_qty": s(q) / cnt,
            "avg_price": s(p) / cnt, "avg_disc": s(d) / cnt,
            "count_order": cnt, "abs": {"sum_qty": s(np.abs(q)),
                                        "sum_base_price": s(np.abs(p)),
                                        "sum_disc_price": s(np.abs(dp)),
                                        "sum_charge": s(np.abs(dp * (1 + t))),
                                        "avg_qty": s(np.abs(q)) / cnt,
                                        "avg_price": s(np.abs(p)) / cnt,
                                        "avg_disc": s(np.abs(d)) / cnt}}


def _q1_groups(lineitem, keep: np.ndarray):
    """(the (l_returnflag, l_linestatus) pairs of the kept rows in key
    order, each kept row's group), from the dictionaries' codes."""
    rf = lineitem["l_returnflag"].combine_chunks()
    ls = lineitem["l_linestatus"].combine_chunks()
    rfd, lsd = rf.dictionary.to_pylist(), ls.dictionary.to_pylist()
    code = rf.indices.to_numpy()[keep].astype(np.int64) * len(lsd) + \
        ls.indices.to_numpy()[keep]
    present = np.flatnonzero(np.bincount(code, minlength=len(rfd) *
                                         len(lsd)))
    pairs = sorted((rfd[c // len(lsd)], lsd[c % len(lsd)], c)
                   for c in present)
    group = np.full(len(rfd) * len(lsd), -1, np.int64)
    group[[c for _, _, c in pairs]] = np.arange(len(pairs))
    return [(r, s) for r, s, _ in pairs], group[code]


def q1_differ(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """The Q1 columns of ``got`` (a to_pydict) that differ from
    ``q1_numpy``'s: keys and counts exact, sums and means within ``rtol``
    of the sums of |x|."""
    bad = [k for k in ("l_returnflag", "l_linestatus", "count_order")
           if list(got[k]) != list(want[k])]
    for k, scale in want["abs"].items():
        g = np.asarray(got[k], dtype=np.float64)
        if g.shape != scale.shape or not np.all(
                np.abs(g - want[k]) <= rtol * scale + 1e-12):
            bad.append(k)
    return bad


def decimal_lineitem(lineitem, max_batch_rows: int, device=None):
    """``DECIMAL_Q1_COLUMNS`` of a pyarrow lineitem staged on ``device`` in
    batches of ``max_batch_rows`` rows, the spec's DECIMAL(15,2) columns as
    decimal128(15, 2) from their integer cents (no pyarrow decimals) and
    l_extendedprice also at decimal128(38, 2), two limbs, as
    ``DECIMAL_WIDE``; returns (the Table, the cents by column)."""
    from .core import datatype as dt
    from .core.schema import Field, Schema
    cents = {c: np.rint(lineitem[c].to_numpy() * 100).astype(np.int64)
             for c in DECIMAL_COLUMNS}
    cents[DECIMAL_WIDE] = cents["l_extendedprice"]
    types = {c: dt.decimal128(15, 2) for c in DECIMAL_COLUMNS}
    types[DECIMAL_WIDE] = dt.decimal128(38, 2)
    rest = Table.from_pyarrow(
        lineitem.select([c for c in DECIMAL_Q1_COLUMNS["lineitem"]
                         if c not in DECIMAL_COLUMNS]),
        max_rows_per_batch=max_batch_rows, device=device)
    schema = Schema(tuple(rest.schema.fields) + tuple(
        Field(c, t, False) for c, t in types.items()))
    batches, start = [], 0
    for b in rest.batches:
        n = int(b.length)
        arrays = list(b.arrays)
        for c, t in types.items():
            v = cents[c][start:start + n]
            if t.wide:
                v = np.stack([v, v >> 63], axis=1)
            arrays.append(array_from_numpy(v, type=t, capacity=b.capacity,
                                           device=device))
        batches.append(Batch(schema, arrays, n))
        start += n
    return Table(schema, batches), cents


def decimal_q1_declarations(lineitem: Table):
    """(Q1's filter and exact decimal sums by (l_returnflag,
    l_linestatus), ordered by them; the rows of ``DECIMAL_WIDE > 50000.00``
    against a decimal scalar, sorted by (``DECIMAL_WIDE`` descending,
    l_orderkey ascending))."""
    import datetime as _dtm
    import decimal
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, OrderByNodeOptions,
                        TableSourceNodeOptions)
    from .compute.expressions import literal
    from .core import datatype as dt
    keys = ["l_returnflag", "l_linestatus"]
    source = Declaration("table_source", TableSourceNodeOptions(lineitem))
    q1 = Declaration.from_sequence([
        source,
        Declaration("filter", FilterNodeOptions(
            field("l_shipdate") <= literal(_dtm.date(*Q1_SHIPDATE)))),
        Declaration("aggregate", AggregateNodeOptions([
            AggregateSpec("sum", "l_quantity", name="sum_qty"),
            AggregateSpec("sum", "l_extendedprice", name="sum_base_price"),
            AggregateSpec("sum", DECIMAL_WIDE, name="sum_base_price_w"),
            AggregateSpec("sum", "l_discount", name="sum_disc"),
            AggregateSpec("count_all", name="count_order")],
            keys=keys, max_groups=16)),
        Declaration("order_by", OrderByNodeOptions(
            [(k, "ascending") for k in keys]))])
    floor = literal(decimal.Decimal(DECIMAL_PRICE_FLOOR),
                    dt.decimal128(38, 2))
    big = Declaration.from_sequence([
        source,
        Declaration("filter", FilterNodeOptions(field(DECIMAL_WIDE) > floor)),
        Declaration("order_by", OrderByNodeOptions(
            [(DECIMAL_WIDE, "descending"), ("l_orderkey", "ascending")]))])
    return q1, big


def discount_counts_declaration(rows: Table):
    """count_all by the decimal key l_discount, ordered by it."""
    from .acero import AggregateNodeOptions, Declaration, \
        OrderByNodeOptions, TableSourceNodeOptions
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(rows)),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("count_all", name="n")], keys=["l_discount"],
            max_groups=64)),
        Declaration("order_by", OrderByNodeOptions(
            [("l_discount", "ascending")]))])


def entry_decimal_q1(device=None, scale_factor: float = 0.01, seed: int = 42,
                     max_batch_rows: int = 1 << 22, source=None):
    """(step, (lineitem,)): TPC-H Q1's filter and group-by with exact
    decimal sums (Q1's products need decimal arithmetic, which neither
    package has), then the rows priced above ``DECIMAL_PRICE_FLOOR``
    sorted by price, then their count by the decimal l_discount, over
    ``decimal_lineitem``: step(lineitem) -> (Q1 table, sorted rows,
    discount counts). ``step.cents`` holds the integer cents and
    ``step.source`` the pyarrow lineitem (``decimal_q1_numpy``'s
    input)."""
    from .utils.tpch import tpch_table
    cols = DECIMAL_Q1_COLUMNS["lineitem"]
    src = source["lineitem"].select(cols) if source else \
        tpch_table("lineitem", scale_factor, seed, columns=cols)
    li, cents = decimal_lineitem(src, max_batch_rows, device)

    def step(lineitem: Table):
        q1, big = decimal_q1_declarations(lineitem)
        rows = big.to_table()
        return q1.to_table(), rows, \
            discount_counts_declaration(rows).to_table()

    step.cents, step.source = cents, src
    return step, (li,)


def decimal_ints(a: Array) -> np.ndarray:
    """The scaled integers of a decimal column's rows as int64 (a wide
    column's must fit: its high limb the low one's sign)."""
    v = a.values[:int(a.length)].cpu().numpy()
    if v.ndim == 1:
        return v
    if not np.array_equal(v[:, 1], v[:, 0] >> 63):
        raise ValueError("a decimal past int64")
    return v[:, 0]


def decimal_q1_numpy(cents: dict, source) -> dict:
    """``entry_decimal_q1``'s three results in numpy int64 (exact)."""
    import datetime as _dtm
    li = source["lineitem"] if isinstance(source, dict) else source
    keep = li["l_shipdate"].cast("int32").to_numpy() <= \
        (_dtm.date(*Q1_SHIPDATE) - _dtm.date(1970, 1, 1)).days
    groups, gid = _q1_groups(li, keep)

    def s(c):
        # float64 sums of integer cents are exact below 2^53
        out = np.bincount(gid, weights=cents[c][keep], minlength=len(groups))
        if np.abs(out).max(initial=0) >= 2.0 ** 53:
            raise ValueError("a decimal sum past float64's exact range")
        return out.astype(np.int64)
    q1 = {"l_returnflag": [g[0] for g in groups],
          "l_linestatus": [g[1] for g in groups],
          "sum_qty": s("l_quantity"), "sum_base_price": s("l_extendedprice"),
          "sum_base_price_w": s(DECIMAL_WIDE), "sum_disc": s("l_discount"),
          "count_order": np.bincount(gid, minlength=len(groups))}
    price = cents[DECIMAL_WIDE]
    big = np.flatnonzero(price > int(DECIMAL_PRICE_FLOOR.replace(".", "")))
    okey = li["l_orderkey"].to_numpy()
    # (price descending, orderkey) as one int64 key: both below 2^31
    if price.max(initial=0) >= 1 << 31 or okey.max(initial=0) >= 1 << 31:
        raise ValueError("the sort oracle's key needs 31-bit prices and "
                         "order keys")
    key = (((1 << 31) - 1 - price[big]) << 31) | okey[big]
    order = big[np.argsort(key, kind="stable")]
    disc, counts = np.unique(cents["l_discount"][big], return_counts=True)
    return {"q1": q1, "rows": order, "okey": okey, "price": price,
            "discount": disc, "counts": counts}


def decimal_q1_differ(res, want: dict) -> list:
    """What of ``entry_decimal_q1``'s results differs from
    ``decimal_q1_numpy``'s (empty when they agree)."""
    q1, rows, disc = res
    bad = []
    b = q1.combine_chunks().batches[0] if q1.batches else None
    q = want["q1"]
    n = len(q["count_order"])
    if b is None or int(b.length) != n:
        return ["q1 groups"]
    got = q1.to_pydict()
    for k in ("l_returnflag", "l_linestatus"):
        if got[k] != q[k]:
            bad.append(k)
    for k in ("sum_qty", "sum_base_price", "sum_base_price_w", "sum_disc"):
        if not np.array_equal(decimal_ints(b.column(k)), q[k]):
            bad.append(k)
    if not np.array_equal(b.column("count_order").values[:n].cpu().numpy(),
                          q["count_order"]):
        bad.append("count_order")
    order = want["rows"]
    got_price = np.concatenate([decimal_ints(x.column(DECIMAL_WIDE))
                                for x in rows.batches]) if rows.batches \
        else np.zeros(0, np.int64)
    got_okey = _host_values(rows, "l_orderkey") if rows.batches else \
        np.zeros(0, np.int64)
    if not (np.array_equal(got_price, want["price"][order]) and
            np.array_equal(got_okey, want["okey"][order])):
        bad.append("sorted rows")
    d = disc.combine_chunks().batches[0] if disc.batches else None
    if d is None or not np.array_equal(decimal_ints(d.column("l_discount")),
                                       want["discount"]) or \
            not np.array_equal(d.column("n").values[:int(d.length)].cpu()
                               .numpy(), want["counts"]):
        bad.append("discount counts")
    return bad


# ---- across processes (ROADMAP A8) -----------------------------------------
#
# ``dist_worker`` is one process of a group (``parallel/multihost``): it runs
# named cases over the global mesh and writes every Table it got, as host
# arrays, for the launcher (``launch_dist_workers``) to read. The same cases
# run over a single-controller ``DistContext`` of the same mesh
# (``dist_case_tables``), which every process's results must equal bit for
# bit: the same shard holds the same rows in the same order.

DIST_CASES = ("group_by", "join", "sort_at_end", "sort_at_start",
              "raw_rows_retry", "dict_key", "q3", "dryrun",
              "too_small_raises", "q3_fanout_raises", "uint64")


def dist_case_step(ctx: DistContext, name: str, n_rows: int = 4096,
                   num_keys: int = 37, seed: int = 0,
                   max_groups_per_shard: int = 64, n_lineitem: int = 768,
                   q3_batches: int = 0, q3_batch_rows: int = 64,
                   q3_max_groups: int = 256):
    """One case over ``ctx``, its inputs made (on the first shard's
    device): a function of no arguments whose call runs the case and
    gives a Table, a dict of Tables (``dryrun``), or the messages every
    process raised (``too_small_raises``, ``q3_fanout_raises``)."""
    device = ctx.devices[0]
    rng = np.random.default_rng(seed)
    if name == "group_by":
        # the JAX package's multi-process test: 37 keys, sum and count
        cols = {"k": rng.integers(0, num_keys, n_rows),
                "v": rng.standard_normal(n_rows)}
        b = batch_from_numpy(cols, device=device)
        return lambda: ctx.group_by(b, ["k"], [("sum", "v"), ("count_all",)],
                                    max_groups_per_shard=64)
    if name == "entry_distributed":
        step, (b,) = entry_distributed(
            device, ctx.n, n_rows, num_keys, max_groups_per_shard, seed,
            ctx=ctx)
        return lambda: step(b)
    if name == "join":
        keys = rng.permutation(2 * num_keys)
        left = batch_from_numpy({
            "k": array_from_numpy(rng.integers(0, 2 * num_keys, n_rows),
                                  validity=rng.random(n_rows) >= 0.03,
                                  device=device),
            "lv": rng.integers(-1000, 1000, n_rows)}, device=device)
        right = batch_from_numpy({"k": keys[:num_keys],
                                  "rv": rng.standard_normal(num_keys)},
                                 device=device)
        options = HashJoinNodeOptions(
            "full outer", ["k"], ["k"], right_output=["k", "rv"],
            output_suffix_for_right="_r", max_build_rows=2 * num_keys)
        return lambda: ctx.join(left, right, options)
    if name in ("sort_at_end", "sort_at_start"):
        b = batch_from_numpy({
            "k1": array_from_numpy(rng.integers(0, num_keys, n_rows),
                                   validity=rng.random(n_rows) >= 0.05,
                                   device=device),
            "k2": array_from_numpy(
                rng.integers(-100, 100, n_rows).astype(np.int32),
                validity=rng.random(n_rows) >= 0.05, device=device),
            "v": rng.standard_normal(n_rows)}, device=device)
        return lambda: ctx.sort_by(
            b, [("k1", "ascending"), ("k2", "descending")],
            null_placement=name[len("sort_"):])
    if name == "raw_rows_retry":
        # Zipf keys over buckets of one local capacity and 4 groups a
        # shard: the buckets and the group tables overflow, and the
        # group-by retries at doubled capacities
        b = batch_from_numpy({"k": rng.zipf(1.5, n_rows) % (2 * num_keys),
                              "w": rng.integers(0, 50, n_rows)},
                             device=device)
        return lambda: ctx.group_by_raw_rows(
            b, ["k"], [("count_distinct", "w"), ("count_all",)],
            max_groups_per_shard=4, bucket_factor=1)
    if name == "dict_key":
        words = np.array([f"name{i:04d}" for i in range(num_keys)])
        codes = rng.integers(0, num_keys, n_rows)
        b = batch_from_numpy({
            "s": dictionary_from_numpy(codes, words,
                                       validity=rng.random(n_rows) >= 0.05,
                                       device=device),
            "v": rng.integers(0, 100, n_rows)}, device=device)
        return lambda: ctx.group_by(b, ["s"], [("sum", "v"), ("min", "v")],
                                    max_groups_per_shard=2 * num_keys)
    if name in ("q3", "q3_fanout_raises"):
        li, od, cu = example_columns_q3(n_lineitem, seed)
        if q3_batches:
            li = {k: v[:q3_batches * q3_batch_rows] for k, v in li.items()}
        tables = (table_from_numpy(li, q3_batch_rows, device),
                  table_from_numpy(od, q3_batch_rows, device),
                  table_from_numpy(cu, q3_batch_rows, device))
        del li, od, cu
        if name == "q3":
            return lambda: q3_declaration(*tables, q3_max_groups,
                                          dist=ctx).to_table()

        def fanout_raises():
            # a fanout of 2 rows a shard: some shard's probe output
            # outgrows it mid-stream, the rows past it are dropped on every
            # process, and finish raises the gathered error on every one
            try:
                q3_declaration(*tables, q3_max_groups, dist=ctx,
                               fanout_capacity=2).to_table()
            except RuntimeError as e:
                return str(e)
            raise AssertionError(f"{name}: no error raised")
        return fanout_raises
    if name == "dryrun":
        def dryrun():
            out = dryrun_multichip(ctx=ctx)
            del out["q3_columns"]
            return out
        return dryrun
    if name == "too_small_raises":
        # 37 keys into group tables of 4 a shard, and one key's 4096 probe
        # rows into a fanout of 64 a shard: both raise, on every process
        b = batch_from_numpy({"k": rng.integers(0, num_keys, n_rows),
                              "v": rng.standard_normal(n_rows)},
                             device=device)
        left = batch_from_numpy({"k": np.zeros(n_rows, np.int64),
                                 "lv": rng.integers(0, 9, n_rows)},
                                device=device)
        right = batch_from_numpy({"k": np.arange(4, dtype=np.int64),
                                  "rv": np.arange(4.0)}, device=device)
        runs = (lambda: ctx.group_by(b, ["k"], [("sum", "v")],
                                     max_groups_per_shard=4),
                lambda: ctx.join(left, right, HashJoinNodeOptions(
                    "inner", ["k"], ["k"], right_output=["rv"],
                    max_build_rows=64), fanout_per_shard=64))

        def too_small():
            msgs = []
            for run in runs:
                try:
                    run()
                except RuntimeError as e:
                    msgs.append(str(e))
                else:
                    raise AssertionError(f"{name}: no error raised")
            return "\n".join(msgs)
        return too_small
    if name == "uint64":
        # keys and values from 2^63 up cross the exchange as their bits
        k = (np.uint64(1) << np.uint64(63)) + \
            rng.integers(0, num_keys, n_rows).astype(np.uint64)
        b = batch_from_numpy({"k": k, "v": rng.integers(
            0, 1 << 62, n_rows).astype(np.uint64) << np.uint64(1)},
            device=device)
        return lambda: ctx.group_by(b, ["k"], [("min", "v"), ("max", "v"),
                                               ("count_all",)],
                                    max_groups_per_shard=64)
    raise ValueError(f"no distributed case {name!r}")


def dist_case_tables(ctx: DistContext, cases=DIST_CASES, run=None,
                     **params) -> dict:
    """Each named case over ``ctx`` (``dist_case_step``, with ``params``):
    name -> Table or message; a case that gives several Tables (``dryrun``)
    gives "name.check" for each. ``run(name, step)`` runs a case's step
    (default: ``step()``)."""
    out = {}
    for name in cases:
        step = dist_case_step(ctx, name, **params)
        got = step() if run is None else run(name, step)
        del step
        if isinstance(got, dict):
            out.update({f"{name}.{k}": v for k, v in got.items()})
        else:
            out[name] = got
    return out


def _host_bits(x) -> np.ndarray:
    from .ops.bits import as_signed_bits
    return as_signed_bits(x).cpu().numpy()


def table_host_arrays(tables: dict) -> Dict[str, np.ndarray]:
    """The host arrays of ``dist_case_tables``' results: per case its
    batches' lengths, each column's values (bits) and validity over the
    rows in order, a dictionary column's dictionary (offsets and bytes),
    or the message it raised."""
    out = {}
    for name, t in tables.items():
        if isinstance(t, str):
            out[f"{name}.error"] = np.array(t)
            continue
        out[f"{name}.lengths"] = np.array([len(b) for b in t.batches],
                                          np.int64)
        for i, f in enumerate(t.schema.fields):
            cols = [b.arrays[i] for b in t.batches]
            lens = [len(b) for b in t.batches]
            vals = [_host_bits(a.values[:n]) for a, n in zip(cols, lens)]
            valid = [a.validity_or_true()[:n].cpu().numpy()
                     for a, n in zip(cols, lens)]
            out[f"{name}.{i}.values"] = np.concatenate(vals) if vals \
                else np.zeros(0)
            out[f"{name}.{i}.validity"] = np.concatenate(valid) if valid \
                else np.zeros(0, bool)
            d = cols[0].dictionary if cols else None
            if d is not None:
                n = int(d.length)
                out[f"{name}.{i}.dictionary"] = _host_bits(
                    d.values[:int(d.offsets[n])])
                out[f"{name}.{i}.dictionary_offsets"] = \
                    d.offsets[:n + 1].cpu().numpy()
    return out


def _resolve_hook(hook: Optional[str]):
    if hook is None:
        return None
    import importlib
    module, fn = hook.split(":")
    return getattr(importlib.import_module(module), fn)


def dist_worker(rank: int, world: int, port: int, local_devices, backend,
                out_dir: str, cases=DIST_CASES, params=None,
                hook: Optional[str] = None, timeout: float = 120.0,
                threads: int = 0) -> None:
    """One process of a ``world``-process group on this host
    (``multihost.initialize`` at ``127.0.0.1:port``, this process's shards
    on ``local_devices`` over ``backend``): runs ``cases`` over the global
    mesh (``dist_case_tables``; ``hook``, "module:function", runs each
    case), then writes ``table_host_arrays`` of the results to
    ``out_dir/rank<rank>.npz``, with whether jax or the JAX package were
    ever imported here."""
    import os
    import sys
    import torch
    from .parallel import multihost
    if threads:
        torch.set_num_threads(threads)
    ctx = multihost.initialize(
        coordinator=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank, local_devices=local_devices, backend=backend,
        timeout=timeout)
    try:
        tables = dist_case_tables(ctx, cases, _resolve_hook(hook),
                                  **(params or {}))
        arrays = table_host_arrays(tables)
        arrays["imported_jax"] = np.array(
            any(m == "jax" or m.startswith(("jax.", "arrow_tpu."))
                or m == "arrow_tpu" for m in sys.modules))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    finally:
        multihost.shutdown()


def launch_dist_workers(world: int, local_devices, backend: str,
                        cases=DIST_CASES, params=None,
                        hook: Optional[str] = None, timeout: float = 300.0,
                        threads: int = 0):
    """Start ``world`` processes of ``dist_worker`` on this host (a free
    port, a temporary directory), wait for all of them at most ``timeout``
    seconds (killing every one at the limit), and return (per rank the
    dict of its arrays, per rank its output). Raises naming the ranks that
    failed, with their output."""
    import json
    import os
    import shutil
    import socket
    import subprocess
    import sys
    import tempfile
    import time
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="arrow_tpu_torch_dist_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    # the processes share this host: gloo's connections over loopback
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    code = ("import json, sys; from arrow_tpu_torch.entry import "
            "dist_worker; dist_worker(**json.loads(sys.argv[1]))")
    procs, logs = [], []
    try:
        for rank in range(world):
            kw = dict(rank=rank, world=world, port=port,
                      local_devices=[str(d) for d in local_devices],
                      backend=backend, out_dir=out_dir, cases=list(cases),
                      params=params or {}, hook=hook,
                      timeout=max(timeout - 10, 10), threads=threads)
            log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, json.dumps(kw)], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=root))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                break
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        failed = [r for r, p in enumerate(procs)
                  if p.poll() is not None and p.returncode != 0]
        if hung or failed:
            raise RuntimeError(
                f"launch_dist_workers: ranks {failed} failed, ranks {hung} "
                f"ran past {timeout} s; output:\n" + "\n".join(
                    f"--- rank {r} ---\n{o[-4000:]}"
                    for r, o in enumerate(outputs)))
        results = []
        for rank in range(world):
            with np.load(os.path.join(out_dir, f"rank{rank}.npz")) as z:
                results.append({k: z[k] for k in z.files})
        return results, outputs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(out_dir, ignore_errors=True)


# ---- the out-of-core and dataset layer: a scan, the external sort, the Grace
# join (paths 20-22 of chip_smoke.py) ------------------------------------------

DISK_SORT_COLUMNS = SMERGE_COLUMNS
DISK_SORT_KEYS = SMERGE_KEYS
PJOIN_COLUMNS = {"orders": ["o_orderkey", "o_custkey", "o_orderdate",
                            "o_totalprice"],
                 "lineitem": ["l_orderkey", "l_linenumber", "l_shipdate",
                              "l_extendedprice"]}
# the spill budgets: 1/8 of the sorted input's device bytes (about 15 runs
# at SF 10), 1/4 of the join's build side; the join's second check runs on
# a tenth of each table
DISK_SORT_SPILL_FRACTION = 8
PJOIN_SPILL_FRACTION = 4
PJOIN_SLICE_FRACTION = 10


def entry_scan_q12(device=None, scale_factor: float = 0.01, seed: int = 42,
                   max_batch_rows: int = 1 << 22, source=None):
    """(step, (lineitem dataset, orders dataset)): TPC-H Q12 over dataset
    scans, the tables laid out as a data lake keeps them. Set-up writes
    lineitem (``Q12_COLUMNS``) with ``dataset.write_dataset`` as a
    hive-partitioned parquet dataset by ``l_shipmode``, and orders as one
    parquet file, under a new temporary directory (``step.root``;
    ``step.cleanup()`` removes it), from the port's TPC-H tables at
    ``scale_factor`` or from ``source``. step(lineitem, orders) -> the
    Table of ``q12_declaration`` with ``scan`` sources on ``device`` in
    batches of ``max_batch_rows`` rows: the lineitem scan's filter is
    ``q12_filter``, whose ``is_in(l_shipmode, ...)`` prunes fragments on
    the host and whose date conjuncts run on the device.
    ``dataset.STATS`` counts the fragments read and pruned and the bytes
    read; ``step.source`` holds the pyarrow tables (``q12_pyarrow``'s
    input)."""
    import os
    import shutil
    import tempfile
    from .acero import Declaration, ScanNodeOptions
    from .dataset import dataset, write_dataset
    from .utils.tpch import tpch_table
    src = {name: (source[name].select(cols) if source else
                  tpch_table(name, scale_factor, seed, columns=cols))
           for name, cols in Q12_COLUMNS.items()}
    root = tempfile.mkdtemp(prefix="arrow_tpu_scan_q12_")
    li_root, od_root = (os.path.join(root, n) for n in ("lineitem",
                                                        "orders"))
    write_dataset(src["lineitem"], li_root, partitioning=["l_shipmode"])
    write_dataset(src["orders"], od_root)
    n_orders = src["orders"].num_rows

    def step(lineitem, orders) -> Table:
        return q12_declaration(
            Declaration("scan", ScanNodeOptions(
                lineitem, filter=q12_filter(), batch_rows=max_batch_rows,
                device=device)),
            Declaration("scan", ScanNodeOptions(
                orders, batch_rows=max_batch_rows, device=device)),
            build_rows=n_orders).to_table()

    step.source = src
    step.root = root
    step.cleanup = lambda: shutil.rmtree(root, ignore_errors=True)
    return step, (dataset(li_root, partitioning=["l_shipmode"]),
                  dataset(od_root))


def _staged_bytes(rb) -> int:
    """The device bytes of a pyarrow record batch of flat and string
    columns once staged (``core/interop``'s capacities: the rows' bucket,
    a pool's bucket, validity where there are nulls)."""
    import pyarrow as pa
    from .core.interop import pad_capacity
    cap = pad_capacity(rb.num_rows)
    total = 0
    for col in rb.columns:
        if pa.types.is_string(col.type) or pa.types.is_binary(col.type):
            used = col.buffers()[1] and int(np.frombuffer(
                col.buffers()[1], np.int32)[col.offset + len(col)] -
                np.frombuffer(col.buffers()[1], np.int32)[col.offset])
            total += 4 * (cap + 1) + pad_capacity(max(used or 0, 1))
        else:
            total += cap * col.type.bit_width // 8 if col.type.bit_width > 1 \
                else cap
        if col.null_count:
            total += cap
    return total


def entry_disk_sort(device=None, scale_factor: float = 0.01, seed: int = 42,
                    max_batch_rows: int = 1 << 22, source=None):
    """(step, (record batches,)): the external sort. Set-up takes the port's
    TPC-H lineitem (``DISK_SORT_COLUMNS``; or ``source``), casts
    ``l_shipmode`` from its dictionary to a plain string column on the host
    (so that a string pool goes to disk too: a dictionary column stays in
    memory) and cuts it into record batches of ``max_batch_rows`` rows.
    ``step.input_bytes`` is their device bytes once staged,
    ``step.spill_bytes`` that over ``DISK_SORT_SPILL_FRACTION``.

    step(batches, spill_bytes=-1, stop_after=None) -> the
    Table of ``order_by`` on ``DISK_SORT_KEYS`` over a ``source`` that
    stages each record batch on ``device`` as it is pulled (nothing of the
    input is resident before), with ``spill_bytes`` (-1:
    ``step.spill_bytes``; None: in memory), consumed through
    ``Declaration.to_batches_prefetched``.
    With ``stop_after`` the consumer requests a stop (a ``StopSource``)
    once it holds that many batches, and the run raises
    ``CancelledError``. ``spill.STATS`` counts the runs and the bytes to
    and from disk; ``step.source`` holds the pyarrow table."""
    import pyarrow as pa
    from .acero import (Declaration, OrderByNodeOptions, SourceNodeOptions)
    from .core.interop import batch_from_pyarrow
    from .core.schema import Schema
    from .utils.cancel import StopSource
    from .utils.tpch import tpch_table
    cols = DISK_SORT_COLUMNS["lineitem"]
    src = source["lineitem"].select(cols) if source else \
        tpch_table("lineitem", scale_factor, seed, columns=cols)
    i = src.schema.get_field_index("l_shipmode")
    src = src.set_column(i, "l_shipmode",
                         src["l_shipmode"].cast(pa.string())).combine_chunks()
    rbs = src.to_batches(max_chunksize=max_batch_rows)
    schema = Schema.from_pyarrow(src.schema)
    dev = resolve_device(device)

    def step(batches, spill_bytes=-1,
             stop_after: Optional[int] = None) -> Table:
        if spill_bytes == -1:
            spill_bytes = step.spill_bytes

        def staged():
            for rb in batches:
                yield batch_from_pyarrow(rb, device=dev, _ingest=False)
        decl = Declaration.from_sequence([
            Declaration("source", SourceNodeOptions(schema, staged)),
            Declaration("order_by", OrderByNodeOptions(
                list(DISK_SORT_KEYS), spill_bytes=spill_bytes))])
        stop = StopSource() if stop_after is not None else None
        out = []
        for b in decl.to_batches_prefetched(
                stop_token=None if stop is None else stop.token()):
            out.append(b)
            if stop is not None and len(out) >= stop_after:
                stop.request_stop("the consumer stopped the sort")
        return Table(schema, out)

    step.input_bytes = sum(_staged_bytes(rb) for rb in rbs)
    step.spill_bytes = step.input_bytes // DISK_SORT_SPILL_FRACTION
    step.source = {"lineitem": src}
    return step, (rbs,)


def disk_sort_order(source) -> np.ndarray:
    """numpy's stable sort of ``entry_disk_sort``'s ``step.source`` by
    ``DISK_SORT_KEYS`` (the oracle's permutation)."""
    import pyarrow as pa
    src = source["lineitem"]
    return np.lexsort([src[name].cast(pa.int32()).to_numpy()
                       if pa.types.is_date32(src[name].type)
                       else src[name].to_numpy()
                       for name, _ in reversed(DISK_SORT_KEYS)])


def _host_strings(t: Table, name: str):
    """A string column's row lengths and bytes over the table's batches,
    on the host."""
    lens, pools = [], []
    for b in t.batches:
        c = b.column(name)
        n = int(b.length)
        off = c.offsets[:n + 1].cpu().numpy().astype(np.int64)
        lens.append(np.diff(off))
        pools.append(c.values[int(off[0]):int(off[-1])].cpu().numpy())
    return np.concatenate(lens), np.concatenate(pools)


def disk_sort_differ(out: Table, source, order: np.ndarray) -> list:
    """The columns of a sorted lineitem that differ from ``source``'s rows
    taken in ``order`` (``disk_sort_order``; empty when it is right): each
    fixed-width column value for value, the string column by its row
    lengths and bytes."""
    import pyarrow as pa
    src = source["lineitem"]
    if out.num_rows != src.num_rows:
        return ["rows"]
    bad = []
    for name in src.column_names:
        want = src[name].combine_chunks().take(pa.array(order))
        if pa.types.is_string(want.type):
            lens, pool = _host_strings(out, name)
            off = np.frombuffer(want.buffers()[1], np.int32)[
                want.offset:want.offset + len(want) + 1].astype(np.int64)
            wpool = np.frombuffer(want.buffers()[2], np.uint8)[
                off[0]:off[-1]]
            ok = np.array_equal(lens, np.diff(off)) and \
                np.array_equal(pool, wpool)
        else:
            if pa.types.is_date32(want.type):
                want = want.cast(pa.int32())
            ok = np.array_equal(_host_values(out, name), want.to_numpy())
        if not ok:
            bad.append(name)
    return bad


def same_rows(a: Table, b: Table) -> list:
    """The columns in which two Tables' rows differ in order (empty when
    they hold the same rows in the same order): values and validity of
    the live rows, a string column's offsets from its first row and its
    used bytes; compared on their device, batch boundaries ignored."""
    import torch
    from .ops.concat import concat_batches
    if a.num_rows != b.num_rows:
        return ["rows"]
    if not a.batches:
        return []
    ca, cb = (concat_batches(t.batches) if len(t.batches) > 1
              else t.batches[0] for t in (a, b))
    n = int(ca.length)
    bad = []
    for name in ca.schema.names:
        x, y = ca.column(name), cb.column(name)
        vx = x.validity_or_true()[:n]
        vy = y.validity_or_true()[:n]
        if x.offsets is not None:
            ox = x.offsets[:n + 1].long()
            oy = y.offsets[:n + 1].long()
            same = torch.equal(ox - ox[0], oy - oy[0]) and torch.equal(
                x.values[ox[0]:ox[-1]], y.values[oy[0]:oy[-1]])
        else:
            same = torch.equal(torch.where(vx, x.values[:n], 0),
                               torch.where(vy, y.values[:n], 0))
        if not (same and torch.equal(vx, vy)):
            bad.append(name)
    return bad


def entry_partitioned_join(device=None, scale_factor: float = 0.01,
                           seed: int = 42, max_batch_rows: int = 1 << 22,
                           source=None):
    """(step, (lineitem, orders)): the Grace hash join. The port's TPC-H
    orders (``PJOIN_COLUMNS``, the build side) and lineitem (the probe
    side), or ``source``'s, staged on ``device`` in batches of
    ``max_batch_rows`` rows; ``step.build_bytes`` is the orders' device
    bytes, ``step.spill_bytes`` that over ``PJOIN_SPILL_FRACTION``.
    step(lineitem, orders, join_type="inner", spill_bytes=-1) -> the Table
    of ``hashjoin`` on l_orderkey = o_orderkey with ``spill_bytes`` (-1:
    ``step.spill_bytes``; None: in memory): past the budget both sides go
    to 16 partitions on disk and the join runs partition by partition. ``spill.STATS`` counts the
    partition files and the bytes; ``step.source`` holds the pyarrow
    tables (``pjoin_slices``' input)."""
    from .acero import Declaration, TableSourceNodeOptions
    from .acero.spill import batch_device_bytes
    source, t = tpch_tables(scale_factor, seed, PJOIN_COLUMNS,
                            max_batch_rows, device, source)

    def step(lineitem: Table, orders: Table, join_type: str = "inner",
             spill_bytes=-1) -> Table:
        if spill_bytes == -1:
            spill_bytes = step.spill_bytes
        return Declaration("hashjoin", HashJoinNodeOptions(
            join_type, left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            max_build_rows=max(orders.num_rows, 16),
            spill_bytes=spill_bytes), [
            Declaration("table_source", TableSourceNodeOptions(lineitem)),
            Declaration("table_source", TableSourceNodeOptions(orders))]
        ).to_table()

    step.build_bytes = sum(batch_device_bytes(b)
                           for b in t["orders"].batches)
    step.spill_bytes = step.build_bytes // PJOIN_SPILL_FRACTION
    step.source = source
    return step, (t["lineitem"], t["orders"])


def pjoin_slices(source, device=None, max_batch_rows: int = 1 << 22):
    """(lineitem, orders) Tables of about a ``PJOIN_SLICE_FRACTION``-th of
    each of
    ``entry_partitioned_join``'s tables, cut so that both sides have rows
    without a match: the orders' first rows, and the lineitem rows from
    half a slice on (lineitem is generated in order-key order, so its
    slice starts inside the orders' and runs past their end)."""
    li, od = source["lineitem"], source["orders"]
    n_l, n_o = li.num_rows, od.num_rows
    fraction = PJOIN_SLICE_FRACTION
    return (Table.from_pyarrow(li.slice(n_l // (2 * fraction),
                                        n_l // fraction),
                               max_rows_per_batch=max_batch_rows,
                               device=device),
            Table.from_pyarrow(od.slice(0, n_o // fraction),
                               max_rows_per_batch=max_batch_rows,
                               device=device))


def table_device_bytes(t: Table) -> Dict[str, int]:
    """A Table's rows and device bytes: ``live`` (each column's live rows,
    a string column's offsets and used pool bytes, the validity),
    ``capacity`` (its buffers as sized, ``batch_device_bytes``) and
    ``storage`` (the distinct allocations those buffers view: a prefix
    view keeps its whole allocation). One host read a batch."""
    from .acero.nodes import compact_scalars, host_ints
    from .acero.spill import batch_device_bytes
    rows = live = cap = 0
    storages = {}
    for b in t.batches:
        n, *used = host_ints(compact_scalars(b))
        used = iter(used)
        rows += n
        cap += batch_device_bytes(b)
        for a in b.arrays:
            live += 4 * (n + 1) + next(used) if a.type.is_varlen \
                else a.values[:n].nbytes
            if a.validity is not None:
                live += a.validity[:n].nbytes
            for x in (a.values, a.validity, a.offsets):
                if x is not None:
                    st = x.untyped_storage()
                    storages[st.data_ptr()] = st.nbytes()
    return {"rows": rows, "live": live, "capacity": cap,
            "storage": sum(storages.values())}


def sorted_columns(t: Table, keys) -> Dict[str, tuple]:
    """A Table's rows sorted on its device by ``keys`` (names, ascending,
    nulls last): column name -> (values, validity or None) tensors of its
    live rows."""
    from .ops.concat import concat_batches
    if not t.batches:
        return {}
    b = concat_batches(t.batches) if len(t.batches) > 1 else t.batches[0]
    b = take_batch(b, sort_indices_batch(b, SortOptions(
        [(k, "ascending") for k in keys])))
    n = int(b.length)
    return {name: (b.column(name).values[:n],
                   None if b.column(name).validity is None
                   else b.column(name).validity[:n])
            for name in b.schema.names}


def tables_differ(a: Table, b: Table, keys) -> list:
    """The columns in which two Tables differ once both are sorted on the
    device by ``keys`` (a total order of their rows); ["rows"] if their
    row counts do."""
    import torch
    if a.num_rows != b.num_rows:
        return ["rows"]
    sa, sb = sorted_columns(a, keys), sorted_columns(b, keys)
    bad = []
    for name, (va, ma) in sa.items():
        vb, mb = sb[name]
        valid = torch.ones_like(va, dtype=torch.bool) if ma is None else ma
        valid_b = torch.ones_like(vb, dtype=torch.bool) if mb is None else mb
        same = torch.equal(valid, valid_b) and torch.equal(
            torch.where(valid, va, torch.zeros_like(va)),
            torch.where(valid_b, vb, torch.zeros_like(vb)))
        if not same:
            bad.append(name)
    return bad


# ---- Substrait, Avro and the plan drivers --------------------------------------

def entry_substrait_q3(device=None, n_lineitem: int = 768, seed: int = 0,
                       max_groups: int = 256, max_batch_rows: int = 64,
                       binary: bool = True):
    """(step, (lineitem, orders, customer)): ``entry_q3``'s plan through
    Substrait. step(li, od, cu) -> the Table of ``q3_declaration``
    serialized by ``engine.declaration_to_substrait`` (protobuf with
    ``binary``, else the JSON form) and run by ``engine.run_query`` on
    ``device`` (the Tables are used where they lie). A Substrait plan
    carries no capacities: the consumer's joins and aggregate start from
    the options' defaults and grow as the eager driver grows them."""
    from .engine import declaration_to_substrait, run_query
    tables = _q3_tables(device, n_lineitem, seed, max_batch_rows)

    def step(li_: Table, od_: Table, cu_: Table) -> Table:
        plan, named = declaration_to_substrait(
            q3_declaration(li_, od_, cu_, max_groups), binary=binary)
        return run_query(plan, named, device=li_.device)

    return step, tables


# the columns of TPC-H's orders that the Avro scan reads
AVRO_ORDERS_COLUMNS = ["o_orderkey", "o_orderstatus", "o_totalprice",
                       "o_orderdate"]


def write_avro_orders(root: str, scale_factor: float = 1.0, seed: int = 42,
                      n_files: int = 4, codec: str = "deflate",
                      source=None) -> list:
    """Write TPC-H's orders (``AVRO_ORDERS_COLUMNS``; ``source``: a pyarrow
    Table of them, else ``utils/tpch`` at ``scale_factor``) as ``n_files``
    Avro container files of equal row ranges under ``root`` with
    ``dataset.avro.write_avro``; returns their paths. ``o_orderstatus``, a
    dictionary column in the generator's table, is written as the string
    it stands for (Avro has no dictionary type)."""
    import os
    import pyarrow as pa
    from .dataset.avro import write_avro
    from .utils.tpch import tpch_table
    t = source if source is not None else tpch_table(
        "orders", scale_factor, seed, columns=AVRO_ORDERS_COLUMNS)
    t = t.select(AVRO_ORDERS_COLUMNS)
    status = t.column("o_orderstatus")
    if pa.types.is_dictionary(status.type):
        t = t.set_column(1, "o_orderstatus", status.cast(pa.string()))
    os.makedirs(root, exist_ok=True)
    n = t.num_rows
    paths = []
    for i in range(n_files):
        lo, hi = n * i // n_files, n * (i + 1) // n_files
        path = os.path.join(root, f"orders_{i:02d}.avro")
        write_avro(t.slice(lo, hi - lo), path, codec=codec)
        paths.append(path)
    return paths


def avro_orders_declaration(ds, device=None, batch_rows: int = 1 << 22):
    """scan(``ds``) -> filter 1995-01-01 <= o_orderdate < 1996-01-01 ->
    aggregate by o_orderstatus: ``n`` (count_all), ``price`` (sum of
    o_totalprice)."""
    import datetime
    from .acero import (AggregateNodeOptions, Declaration,
                        FilterNodeOptions, ScanNodeOptions)
    lo, hi = datetime.date(1995, 1, 1), datetime.date(1996, 1, 1)
    return Declaration.from_sequence([
        Declaration("scan", ScanNodeOptions(ds, batch_rows=batch_rows,
                                            device=device)),
        Declaration("filter", FilterNodeOptions(
            (field("o_orderdate") >= lo) & (field("o_orderdate") < hi))),
        Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("count_all", name="n"),
             AggregateSpec("sum", "o_totalprice", name="price")],
            keys=["o_orderstatus"], max_groups=16)),
    ])


def avro_orders_numpy(source) -> Dict[str, tuple]:
    """The Avro scan's answer from a pyarrow Table of the same rows, with
    numpy: status -> (count, sum of o_totalprice, sum of |o_totalprice|)
    over 1995's orders."""
    days = source.column("o_orderdate").cast("int32").to_numpy()
    keep = (days >= 9131) & (days < 9496)       # 1995-01-01, 1996-01-01
    status = np.asarray(source.column("o_orderstatus").cast(
        "string").to_pylist(), dtype=object)[keep]
    price = source.column("o_totalprice").to_numpy()[keep]
    return {s: (int((status == s).sum()), float(price[status == s].sum()),
                float(np.abs(price[status == s]).sum()))
            for s in sorted(set(status))}


def entry_avro_scan(device=None, scale_factor: float = 0.01, seed: int = 42,
                    n_files: int = 4, batch_rows: int = 1 << 22,
                    root: Optional[str] = None):
    """(step, (dataset,)): TPC-H's orders at ``scale_factor`` as ``n_files``
    deflate Avro files (``write_avro_orders``), scanned by the ``dataset``
    layer on ``device``: step(ds) -> the Table of
    ``avro_orders_declaration``. Set-up writes the files under a new
    temporary directory (``step.cleanup()`` removes it), or reads those
    already under ``root`` (left in place). ``step.source`` holds the
    pyarrow Table written, or None when ``root`` was given."""
    import shutil
    import tempfile
    from .dataset import dataset
    source = None
    cleanup = lambda: None
    if root is None:
        from .utils.tpch import tpch_table
        root = tempfile.mkdtemp(prefix="arrow_tpu_avro_")
        source = tpch_table("orders", scale_factor, seed,
                            columns=AVRO_ORDERS_COLUMNS)
        write_avro_orders(root, n_files=n_files, source=source)
        cleanup = lambda: shutil.rmtree(root, ignore_errors=True)

    def step(ds) -> Table:
        return avro_orders_declaration(ds, device, batch_rows).to_table()

    step.source = source
    step.root = root
    step.cleanup = cleanup
    return step, (dataset(root),)


# ``to_table``'s drivers by name: the arguments that pick each one
PLAN_DRIVERS = {"eager": {}, "fused": {"fused": True}, "lazy": {"lazy": True}}


def plan_driver(decl, driver: str = "fused") -> Table:
    """``decl.to_table`` through the named driver of ``PLAN_DRIVERS``."""
    return decl.to_table(**PLAN_DRIVERS[driver])


def entry_fused_q3(device=None, n_lineitem: int = 768, seed: int = 0,
                   max_groups: int = 256, max_batch_rows: int = 64,
                   driver: str = "fused"):
    """``entry_q3`` through a named plan driver (``plan_driver``): "fused"
    (``acero/fuse.py``; on the card each lineitem morsel after the first
    replays a captured graph of its segment), "lazy" or "eager".
    ``acero.fuse.STATS`` counts the fused runs, their host reads, graphs
    and replays."""
    tables = _q3_tables(device, n_lineitem, seed, max_batch_rows)

    def step(li_: Table, od_: Table, cu_: Table) -> Table:
        return plan_driver(q3_declaration(li_, od_, cu_, max_groups), driver)

    return step, tables
