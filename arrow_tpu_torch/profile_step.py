"""Per-layer device times of one step of the port's slices, on one GPU.

    python -m arrow_tpu_torch.profile_step
        [--path generic|dense|dist|distdict|exchange|sort|join|q3|q3dist|
                sortdict|q3s|q3sdist|strings|anyall|q6|q6dist|q13|q22|hb|
                q12|q7|wordcount|baskets|smerge|asof|scanq12|disksort|
                pjoin]
        [--rows N] [--keys N] [--max-groups N] [--shards N] [--steps N]
        [--seed N] [--build-rows N] [--build-keys N]
        [--key-dist uniform|zipf] [--join-type T] [--wide] [--batch-rows N]
        [--staging dictionary|plain]

``--path dist`` is the distributed group-by (``entry_distributed``) over
``--shards`` logical shards of the card (default 8), ``--path exchange``
the raw-row exchange (``shuffle_batch`` by the hash of ``k``, buckets of
twice the local capacity) of the same batch (default 4 shards); their
layers are called once per shard and step (the exchange's
``bucket_positions``, its two kernels, once per step and card), and a
layer's time is the sum over the calls. ``--path dense`` with ``--keys`` past 4096 (and
``--max-groups`` to hold them) is the sorted dense route. ``--path sort`` is
``entry_sort`` (layers: lane build, each ``torch.argsort`` pass of the
lexicographic sort, take); ``--path join`` is ``entry_join`` with
``--build-rows`` build rows over ``--build-keys`` keys and ``--rows`` probe
rows (layers: build, the route's host read, lane build, pack, find with its
``searchsorted``, take indices or pair expansion,
materialize with pack / row gather / unpack, finish). ``--path q3`` is
``entry_q3`` over ``--rows`` lineitem rows in ``--batch-rows`` batches
(default 2^22) with ``--max-groups`` (default 2^22): per plan node its own
device ms (each ``next()`` of its batch stream bracketed by events, its
inputs' time subtracted) and its host reads per step, beside the layers.
``--path q3dist`` is ``entry_q3_dist``: the same plan with ``dist=`` over
``--shards`` logical shards (default 8) on both joins and the aggregate,
``--max-groups`` per shard (default 2^22); its layers add the distributed
join's build accumulation, build, probe and finish, the group-by's
per-shard consume and its state-row exchange. ``--path sortdict`` is
``entry_sort_dict`` (BASELINE #3's dictionary-string sort: the dictionary
rank among the lane build), ``--path q3s`` ``entry_q3s`` (``q3`` with the
segment a dictionary string), ``--path strings`` ``entry_strings`` (the
generic step keyed by a raw 18-byte string, ``--keys`` customer keys,
default 1,000,000; layers add the pool compaction, its per-byte
selection, the content lanes and their fingerprints, the unique slots).
``--path q3sdist`` is ``entry_q3_dist`` with ``segment="BUILDING"``
(``q3dist`` on ``q3s``'s tables), ``--path distdict`` ``entry_dist_dict``
(``dist`` keyed by a dictionary of ``--keys`` TPC-H ``C_NAME`` values,
default 1,000,000: the exchange hashes, and the merge keys, the codes by
their content lanes). ``--path anyall`` is ``entry_any_all`` (``dense``
with any / all of a bool column on the dense kernel's ``any8`` / ``all8``
kinds), ``--path q6`` ``entry_groupby_q6`` (db-benchmark's groupby q6,
median and sd of ``v3`` by ``id4``, ``id5``, through ``Table.group_by``:
layers add the median's and the sd's consume and the median's finalize
sort), ``--path q6dist`` ``entry_dist_groupby_q6`` (q6 over ``--shards``
logical shards, default 4: the raw-row exchange, then each shard's
consume and finalize). ``--path q13`` and ``--path q22`` are ``entry_q13``
and ``entry_q22`` (TPC-H Q13, Q22) at scale factor 10 (``TPCH_SF``, as in
``chip_smoke.py``) in ``--batch-rows`` batches: per plan node, and per layer, among them the
regex's host hop (the pushdown's device distinct, the column to the host,
RE2, the result back) and the string functions' calls. ``--path hb`` is
``entry_host_boundary`` (bench.py's host_boundary regex filter) over
``--rows`` rows, ``s`` staged as ``--staging`` (default plain: the
pushdown; dictionary: the dictionary branch). ``--path q12`` and ``--path
q7`` are ``entry_q12`` and ``entry_q7`` (TPC-H Q12, Q7) at ``TPCH_SF``:
per plan node, and per layer, among them the casts, ``is_in`` and the
temporal fields. ``--path wordcount`` and ``--path baskets`` are
``entry_wordcount`` and ``entry_baskets`` at ``TPCH_SF``: per plan node,
and per layer the split, the flatten, the list and pivot aggregators and
the list and struct functions. ``--path smerge`` is
``entry_sorted_merge`` (the merge of 8 sorted partitions of lineitem at
``TPCH_SF``): per plan node, and per layer the rounds' sorts, their
cross-batch lanes, the takes and the host reads. ``--path asof`` is
``entry_asof`` over ``--rows`` quotes and a quarter as many trades
(tolerance ``--tolerance``, default -1 s): per layer the grouping of the
``by`` keys, the lexsort, the segmented carry, the payload takes, the
carry's shrink and the host reads. ``--path scanq12`` is ``entry_scan_q12``
(Q12 over dataset scans at ``TPCH_SF``; its parquet set-up outside the
step): per plan node, and per layer the scan's read and staging and its
residual filter. ``--path disksort`` is ``entry_disk_sort`` at ``TPCH_SF``
past its budget: the runs' sort, their copy to the host and their write,
the merge and its reads of the runs. ``--path pjoin`` is
``entry_partitioned_join`` at ``TPCH_SF`` past its budget: the partition
ids, the split (B4 and ``partition_positions``), the partition files'
writes and reads, and each partition's build, probe and finish. For
``disksort`` and ``pjoin`` a last JSON line accounts for the device
memory of the step in memory and past its budget (``memory_account``). A layer
around host work (a read or a write of a file) spans the host's time too:
its end event is queued after that work.

Wraps the functions that make up the step's layers so that each call is
bracketed by two CUDA events on the current stream (no synchronisation
inside the step), runs ``--steps`` steps after one warm-up, and prints per
layer the mean device milliseconds between its events (layers nest: a
name with a dot lies inside the layer before the dot). Then one more step
runs under ``torch.profiler``: the sum of the kernels' device time against
the step's host-clock time gives the device's idle share, and the ten
kernels with the most device time are listed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

# TPC-H scale factor of ``--path q13|q22|q12|q7|wordcount|baskets|smerge|
# scanq12|disksort|pjoin``: chip_smoke.py's paths 10, 11, 13-17, 20-22
TPCH_SF = 10


def node_layers(torch, nodes, Batch, stack):
    """Wrap every plan node class's ``batches()`` so that each ``next()`` of
    a node's stream is bracketed by two CUDA events (it includes the work of
    the node's inputs, pulled inside it), and count the host reads
    (``host_ints``, the aggregate's route probe, a device length read by
    ``len``, a ``DistContext.fetch`` of the shards' scalars) against the
    node being pulled, or the top-level label outside any node.
    Returns (spans: label -> [(start, end)], reads: label -> count,
    children: label -> input labels, restore: a function that takes the
    wrappers off); labels are ``factory#k`` in the order the nodes first
    run (sources by their first column, filters by their expression, joins
    by their probe keys), counted afresh for each plan built."""
    spans, reads, children = defaultdict(list), defaultdict(int), {}
    labels, current, undo = {}, [], []

    def label_of(node):
        if id(node) not in labels:
            name = node.factory_name
            if name == "table_source":
                name += f"[{node.output_schema().names[0]}]"
            elif name == "filter":
                name += f"[{node.options.filter_expression!r}]"
            elif name == "hashjoin":
                name += f"[{','.join(node.options.left_keys)}]"
            k = sum(lab.startswith(name + "#") for lab in labels.values())
            labels[id(node)] = f"{name}#{k}"
        return labels[id(node)]

    def wrap_stream(cls):
        inner = cls.batches
        undo.append((cls, "batches", inner))

        def batches(self):
            lab = label_of(self)
            children[lab] = [label_of(c) for c in self.inputs]
            it = inner(self)
            while True:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                current.append(lab)
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    current.pop()
                    end.record()
                    spans[lab].append((start, end))
                yield b
        cls.batches = batches

    for cls in set(nodes.FACTORIES.values()):
        wrap_stream(cls)
    build = nodes.ExecNode.__init__
    undo.append((nodes.ExecNode, "__init__", build))

    def init(self, *a, **kw):
        if not current and not stack:
            labels.clear()      # a new plan: label its nodes afresh
        build(self, *a, **kw)
    nodes.ExecNode.__init__ = init

    def counted(owner, attr, device_read=None):
        inner = getattr(owner, attr)
        undo.append((owner, attr, inner))

        def fn(*a, **kw):
            if device_read is None or device_read(*a):
                reads[current[-1] if current else "driver"] += 1
            return inner(*a, **kw)
        setattr(owner, attr, fn)

    from .parallel.context import DistContext
    counted(nodes, "host_ints",
            lambda vals: any(isinstance(v, torch.Tensor) for v in vals))
    counted(nodes, "_host_probe")
    counted(DistContext, "fetch")
    counted(Batch, "__len__",
            lambda self: not self.has_static_length)

    def restore():
        for owner, attr, inner in reversed(undo):
            setattr(owner, attr, inner)
    return spans, reads, children, restore


def node_times(node_spans, node_reads, node_children, steps: int = 1):
    """Per node label: inclusive and own device ms (its inputs' inclusive
    time subtracted) and host reads, each per step."""
    out = {}
    for name, evs in node_spans.items():
        out[name] = {"inclusive_ms": sum(s.elapsed_time(e)
                                         for s, e in evs) / steps,
                     "host_reads": node_reads.get(name, 0) / steps}
    for name, m in out.items():
        m["own_ms"] = m["inclusive_ms"] - sum(
            out[c]["inclusive_ms"] for c in node_children[name] if c in out)
    if "driver" in node_reads:
        out["driver"] = {"inclusive_ms": 0.0, "own_ms": 0.0,
                         "host_reads": node_reads["driver"] / steps}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("generic", "dense", "dist",
                                       "distdict", "exchange", "sort",
                                       "join", "q3", "q3dist", "sortdict",
                                       "q3s", "q3sdist", "strings",
                                       "anyall", "q6", "q6dist", "q13",
                                       "q22", "hb", "q12", "q7",
                                       "wordcount", "baskets", "smerge",
                                       "asof", "scanq12", "disksort",
                                       "pjoin"),
                    default="generic")
    ap.add_argument("--tolerance", type=int, default=-1_000_000_000)
    ap.add_argument("--staging", choices=("dictionary", "plain"),
                    default="plain")
    ap.add_argument("--batch-rows", type=int, default=1 << 22)
    ap.add_argument("--build-rows", type=int, default=1 << 20)
    ap.add_argument("--build-keys", type=int, default=None)
    ap.add_argument("--key-dist", choices=("uniform", "zipf"),
                    default="uniform")
    ap.add_argument("--join-type", default="inner")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--fanout", type=int, default=None)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--keys", type=int, default=None)
    ap.add_argument("--max-groups", type=int, default=None,
                    help="state slots (per shard for --path dist, distdict,"
                    " q3dist and q3sdist); default 2^22, 2^21 for dist and "
                    "distdict")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from . import entry as entry_mod
    from .acero import nodes
    from .core.batch import Batch
    from .compute.registry import registry
    from .core import interop
    from .ops import aggregates, cuda_kernels, distinct, grouper, \
        hash_aggregate, hashing, join, selection, sorting, strings_regex
    from .parallel import context, dist_agg, dist_join, shuffle

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())

    spans = defaultdict(list)       # layer -> [(start event, end event)]
    stack = []

    def layer(owner, attr, name):
        """Bracket owner.attr with events under ``name``."""
        inner = getattr(owner, attr)

        def timed(*a, **kw):
            full = ".".join(stack + [name]) if stack else name
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            stack.append(name)
            try:
                return inner(*a, **kw)
            finally:
                stack.pop()
                end.record()
                spans[full].append((start, end))
        setattr(owner, attr, timed)

    def gen_layer(owner, attr, name):
        """Bracket each ``next()`` of the generators owner.attr returns
        with events under ``name``."""
        inner = getattr(owner, attr)

        def wrapped(*a, **kw):
            it = inner(*a, **kw)
            while True:
                full = ".".join(stack + [name]) if stack else name
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                stack.append(name)
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    stack.pop()
                    end.record()
                    spans[full].append((start, end))
                yield b
        setattr(owner, attr, wrapped)

    HA = hash_aggregate.HashAggregate
    layer(entry_mod, "execute_scalar_expression", "expression")
    layer(entry_mod, "filter_batch", "filter")
    layer(selection, "get_take_indices", "take_indices")
    layer(selection, "tile_compact_local", "B2_tile_compact_local")
    layer(selection, "_selection_mask", "selection_mask")
    layer(selection, "tile_stitch", "B2b_tile_stitch")
    layer(selection, "take_batch", "take_batch")
    layer(selection, "filter_compact_columns", "B1_filter_compact_columns")
    layer(HA, "probe_scalars", "probe")
    layer(nodes, "_host_probe", "probe_host_read")
    layer(HA, "consume", "consume")
    layer(HA, "consume_dense", "consume_dense")
    layer(hash_aggregate, "dense_group_reduce", "B3_dense_group_reduce")
    layer(HA, "merge_rows", "merge_rows")
    layer(grouper, "group_key_lanes", "lane_build")
    layer(grouper, "sort_group", "sort_group")
    layer(distinct, "_lexsort_perm", "sort")
    layer(hash_aggregate, "make_segment_context", "segment_context")
    layer(grouper.Grouper, "uniques_scatter_reps", "uniques")
    for cls in (aggregates.GroupedCountAll, aggregates.GroupedSum,
                aggregates._GroupedExtremum):
        layer(cls, "consume_grouped", f"agg_{cls.name or 'min_max'}")
    layer(HA, "finalize", "finalize")
    # the other aggregators (q6: the median's buffer and its finalize sort)
    layer(aggregates.GroupedTDigest, "consume_grouped", "agg_tdigest")
    layer(aggregates.GroupedTDigest, "finalize", "tdigest_finalize")
    layer(aggregates._GroupedMoments, "consume_grouped", "agg_moments")
    layer(aggregates._GroupedBoolean, "merge", "agg_merge_any_all")
    # string and dictionary columns
    layer(selection, "_filter_pool", "pool_compaction")
    layer(selection, "_byte_selection", "byte_selection")
    layer(selection, "_gather_bytes", "gather_bytes")
    layer(hashing, "varlen_content_lanes", "content_lanes")
    layer(hashing, "_short_lanes", "short_lanes")
    layer(hashing, "string_fingerprint_exact", "fingerprint")
    layer(hashing, "dict_content_lanes", "dict_content_lanes")
    layer(grouper.SlotStrings, "scatter_from", "slot_scatter")
    layer(grouper.SlotStrings, "to_array", "slots_to_array")
    layer(sorting, "_string_sort_lanes", "string_sort_lanes")
    layer(sorting, "_dictionary_rank", "dictionary_rank")
    # the distributed group-by: per-shard steps, the exchange between them
    layer(dist_agg, "execute_scalar_expression", "expression")
    layer(dist_agg, "filter_batch", "filter")
    layer(dist_agg.DistGroupBy, "_state_rows", "hash_and_dest")
    layer(shuffle, "_batch_dest", "dest")
    layer(shuffle, "hash32", "hash")
    layer(shuffle, "_bucket_positions", "bucket_positions")
    layer(shuffle, "partition_histogram_segments", "B4_partition_histogram")
    layer(shuffle, "partition_positions", "partition_positions")
    layer(shuffle, "partition_for_exchange", "partition_for_exchange")
    layer(shuffle, "_bucket_rows", "send_scatter")
    layer(shuffle, "flatten_received", "flatten_received")
    layer(shuffle, "exchange", "exchange")
    layer(shuffle, "shuffle_rows_receive", "receive_compaction")
    layer(grouper.Grouper, "consume", "grouper_consume")
    layer(grouper.Grouper, "uniques_scatter", "uniques_scatter")
    for cls in (aggregates.GroupedCount, aggregates.GroupedSum,
                aggregates._GroupedExtremum):
        layer(cls, "merge", f"agg_merge_{cls.name or 'min_max'}")
    layer(grouper, "merge_insert", "merge_insert")
    layer(distinct, "segmented_carry_last", "carry_last")
    layer(context.DistContext, "_collect_shards", "collect")
    # the distributed join and the plan's distributed group-by
    DHJ = dist_join.DistHashJoin
    layer(DHJ, "consume_build", "dist_consume_build")
    layer(dist_join._BuildAccum, "append", "append")
    layer(DHJ, "finish_build", "dist_build")
    layer(DHJ, "probe", "dist_probe")
    layer(DHJ, "finish", "dist_finish")
    layer(dist_agg.DistGroupBy, "consume", "dist_consume")
    layer(dist_agg.DistGroupBy, "finalize_table", "dist_finalize")
    # the sorted dense route, sort and join
    layer(hash_aggregate, "sorted_group_reduce", "sorted_group_reduce")
    if args.path in ("sort", "join", "sortdict", "strings") or (
            args.path == "dense" and (args.keys or 0) > 4096):
        layer(torch, "argsort", "torch_argsort")
        layer(torch, "sort", "torch_sort")
        layer(torch, "searchsorted", "torch_searchsorted")
        layer(torch, "segment_reduce", "torch_segment_reduce")
    layer(sorting, "_key_lanes", "lane_build")
    layer(sorting, "_lexsort_perm", "lexsort")
    layer(entry_mod, "sort_indices_batch", "sort_indices")
    layer(entry_mod, "take_batch", "take")
    HJ = join.HashJoin
    layer(entry_mod, "join_routed", "build_and_route")
    layer(HJ, "build", "build")
    layer(join, "sort_group", "sort_group")
    layer(join, "lane_windows", "lane_windows")
    layer(join, "group_key_lanes", "lane_build")
    layer(join, "group_key_lane_list", "lane_build")
    layer(join, "_pack_lanes", "pack")
    layer(HJ, "probe", "probe")
    layer(HJ, "_find_packed", "find")
    layer(join, "merge_find", "merge_find")
    layer(join, "get_take_indices", "take_indices")
    layer(HJ, "_pair_geometry", "expansion")
    layer(join, "rows_of_positions", "rows_of_positions")
    layer(HJ, "_materialize", "materialize")
    layer(join, "pack_columns", "pack_columns")
    layer(join, "unpack_columns", "unpack_columns")
    layer(join, "filter_batch", "filter")
    layer(HJ, "finish", "finish")
    # the plan engine's own layers (the Q3 plan)
    layer(nodes, "execute_scalar_expression", "expression")
    layer(nodes, "filter_batch", "filter")
    layer(nodes, "maybe_compact", "maybe_compact")
    layer(nodes, "consume_routed", "consume_routed")
    layer(nodes, "build_and_route", "build_and_route")
    layer(nodes, "concat_batches", "concat")
    layer(nodes, "sort_indices_batch", "sort_indices")
    layer(nodes, "take_batch", "take")
    # the string functions and the regex family's host hop; Q12 / Q7's
    # casts, set lookups, date compares and temporal field
    for fname in ("match_substring_regex", "utf8_slice_codeunits",
                  "equal", "invert", "is_in", "cast", "year", "less",
                  "less_equal", "greater_equal", "and_kleene", "multiply"):
        layer(registry.get(fname), "exec", fname)
    layer(strings_regex, "_via_pc", "host_hop")
    layer(strings_regex, "_pushdown_encode", "pushdown_encode")
    layer(strings_regex, "_host_regex", "host_regex")
    layer(interop, "array_to_pyarrow", "to_host")
    layer(interop, "array_from_pyarrow", "from_host")
    # the nested layouts: the word count's split and flatten, the baskets'
    # list and pivot aggregators, the list and struct functions, the
    # filter's take of nested columns
    from .ops import nested, pivot
    layer(entry_mod, "wordcount_words", "words")
    for fname in ("utf8_split_whitespace", "list_flatten",
                  "list_value_length", "list_element", "list_slice",
                  "struct_field"):
        layer(registry.get(fname), "exec", fname)
    layer(strings_regex, "_split_at", "split_at")
    layer(nested.GroupedList, "consume", "agg_list")
    layer(nested.GroupedList, "finalize", "list_finalize")
    layer(pivot.GroupedPivotWider, "consume", "agg_pivot_wider")
    layer(pivot.GroupedPivotWider, "finalize", "pivot_finalize")
    layer(pivot, "_set_probe", "pivot_key_probe")
    layer(selection, "_filter_batch_mixed", "filter_nested")
    layer(selection, "_take_list", "take_list")
    # the ordered nodes: sorted_merge's rounds, asofjoin's join
    from .ops import segment
    layer(sorting, "_composite_sort_perm", "sort")
    layer(sorting, "merge_key_lanes", "merge_lanes")
    layer(nodes, "host_ints", "host_read")
    layer(segment, "segmented_carry_last", "carry_last")
    layer(grouper.Grouper, "consume_lanes_grouped", "group_by_keys")
    layer(nodes, "take_array", "take_payload")
    # the out-of-core and dataset layer: the scan, the external sort, the
    # Grace join
    from . import dataset
    from .acero import spill
    layer(dataset.Fragment, "read_pyarrow", "scan_read")
    layer(interop, "table_from_pyarrow", "scan_stage")
    layer(selection, "filter_batch", "scan_filter")
    layer(spill.SpillSorter, "_sorted_with_seq", "run_sort")
    layer(spill, "host_columns", "to_host")
    layer(spill, "_write", "file_write")
    gen_layer(spill, "read_run", "file_read")
    gen_layer(spill.SpillSorter, "finish", "merge")
    layer(join.HashJoin, "partition_ids", "partition_ids")
    layer(spill, "partition_order", "partition_order")
    layer(spill, "partition_histogram_segments", "B4_partition_histogram")
    layer(spill, "partition_positions", "partition_positions")
    layer(spill.GracePartitioner, "add", "partition_split")
    layer(nodes.HashJoinNode, "_build_recover", "partition_build")
    layer(nodes.HashJoinNode, "_probe_retry", "partition_probe")
    node_spans, node_reads, node_children, _ = node_layers(
        torch, nodes, Batch, stack)

    if args.path == "generic":
        step, (b,) = entry_mod.entry_generic(
            None, args.rows, args.keys or 3_000_000, args.seed,
            args.max_groups or 1 << 22)
    elif args.path == "dist":
        step, (b,) = entry_mod.entry_distributed(
            None, args.shards or 8, args.rows, args.keys or 1_000_000,
            args.max_groups or 1 << 21, args.seed)
    elif args.path == "distdict":
        step, (b,) = entry_mod.entry_dist_dict(
            None, args.shards or 8, args.rows, args.keys or 1_000_000,
            args.max_groups or 1 << 21, args.seed)
    elif args.path == "exchange":
        from .core.batch import batch_from_numpy
        b = batch_from_numpy(entry_mod.example_columns_generic(
            args.rows, args.keys or 1_000_000, args.seed))
        ctx = context.DistContext(devices=[b.device] * (args.shards or 4))

        def step(batch):
            sharded = ctx.shard_batch(batch)
            return shuffle.shuffle_batch(
                sharded.shards, ["k"], ctx.devices,
                bucket_capacity=2 * sharded.local_capacity)
    elif args.path == "sort":
        step, (b,) = entry_mod.entry_sort(None, args.rows, args.seed,
                                          args.keys or 1_000_000)
    elif args.path == "sortdict":
        step, (b,) = entry_mod.entry_sort_dict(None, args.rows, args.seed,
                                               args.keys or 1000)
    elif args.path == "strings":
        step, (b,) = entry_mod.entry_strings(
            None, args.rows, args.keys or 1_000_000, args.seed,
            args.max_groups or 1 << 21)
    elif args.path == "q3s":
        qstep, tables = entry_mod.entry_q3s(
            None, args.rows, args.seed, args.max_groups or 1 << 22,
            args.batch_rows)
        b = tables

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "q3":
        qstep, tables = entry_mod.entry_q3(
            None, args.rows, args.seed, args.max_groups or 1 << 22,
            args.batch_rows)
        b = tables

        def step(tables_):
            return qstep(*tables_)
    elif args.path in ("q3dist", "q3sdist"):
        qstep, tables = entry_mod.entry_q3_dist(
            None, args.shards or 8, args.rows, args.seed,
            args.max_groups or 1 << 22, args.batch_rows,
            "BUILDING" if args.path == "q3sdist" else None)
        b = tables

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "join":
        jstep, pair = entry_mod.entry_join(
            None, args.build_rows, args.rows, args.seed, args.join_type,
            args.key_dist, args.build_keys, args.wide, args.fanout)
        b = pair

        def step(batches):
            return jstep(*batches)
    elif args.path == "anyall":
        step, (b,) = entry_mod.entry_any_all(
            None, args.rows, args.keys or 1000, args.seed,
            args.max_groups or entry_mod.MAX_GROUPS)
    elif args.path == "q6":
        step, (b,) = entry_mod.entry_groupby_q6(None, args.rows, args.seed,
                                                args.keys or 100)
    elif args.path == "q6dist":
        step, (b,) = entry_mod.entry_dist_groupby_q6(
            None, args.shards or 4, args.rows, args.seed, args.keys or 100)
    elif args.path in ("q13", "q22", "q12", "q7", "wordcount", "baskets"):
        make = {"q13": entry_mod.entry_q13, "q22": entry_mod.entry_q22,
                "q12": entry_mod.entry_q12, "q7": entry_mod.entry_q7,
                "wordcount": entry_mod.entry_wordcount,
                "baskets": entry_mod.entry_baskets}[args.path]
        qstep, b = make(None, TPCH_SF, args.seed,
                        max_batch_rows=args.batch_rows)

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "smerge":
        qstep, b = entry_mod.entry_sorted_merge(
            None, TPCH_SF, args.seed, max_batch_rows=args.batch_rows)

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "asof":
        qstep, b = entry_mod.entry_asof(None, args.rows, args.rows // 4,
                                        args.seed, args.tolerance,
                                        args.batch_rows)

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "scanq12":
        import atexit
        qstep, b = entry_mod.entry_scan_q12(None, TPCH_SF, args.seed,
                                            args.batch_rows)
        atexit.register(qstep.cleanup)

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "disksort":
        qstep, (b,) = entry_mod.entry_disk_sort(None, TPCH_SF, args.seed,
                                                args.batch_rows)
        step = qstep
    elif args.path == "pjoin":
        qstep, b = entry_mod.entry_partitioned_join(None, TPCH_SF, args.seed,
                                                    args.batch_rows)

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "hb":
        step, (b,) = entry_mod.entry_host_boundary(
            None, args.rows, args.seed, args.staging)
    else:
        step, (b,) = entry_mod.entry(
            None, args.rows, args.keys or 1000, args.seed,
            args.max_groups or entry_mod.MAX_GROUPS)
    step(b)
    torch.cuda.synchronize()
    spans.clear()
    node_spans.clear()
    node_reads.clear()
    strings_regex.reset_host_hops()
    host_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    size = f"SF {TPCH_SF}" if args.path in ("q13", "q22", "q12", "q7",
                                            "wordcount", "baskets",
                                            "smerge", "scanq12", "disksort",
                                            "pjoin") \
        else f"{args.rows} rows"
    hops = {k: v / args.steps for k, v in strings_regex.HOST_HOPS.items()}
    print(f"path {args.path}: {size}; host-clock ms per step "
          f"{[round(t, 3) for t in host_ms]}; host hops per step {hops}")
    layers = {name: sum(s.elapsed_time(e) for s, e in evs) / args.steps
              for name, evs in spans.items()}
    for name, ms in layers.items():
        print(f"  {name:58s} {ms:10.3f} ms")
    nodes_ms = node_times(node_spans, node_reads, node_children, args.steps)
    for name, m in nodes_ms.items():
        print(f"  node {name:24s} own {m['own_ms']:10.3f} ms, inclusive "
              f"{m['inclusive_ms']:10.3f} ms, host reads "
              f"{m['host_reads']:.1f} per step")
    print(json.dumps({"layers_ms": layers, "host_ms": host_ms,
                      "nodes": nodes_ms}))

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device events only: an operator's own entry repeats its kernels'
    # time, and a span's range on the device timeline (``trace_span``'s
    # record_function: a user annotation) spans the kernels inside it
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profiled step: host-clock {wall_ms:.3f} ms, kernels' device "
          f"time {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated()} B; launches "
          f"{dict(cuda_kernels.LAUNCHES)}")
    for e in sorted(events, key=dev_us, reverse=True)[:25]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if args.path == "disksort":
        memory_account(torch, entry_mod, lambda sb: qstep(b, spill_bytes=sb),
                       (spill.SpillSorter, "finish"))
    elif args.path == "pjoin":
        memory_account(torch, entry_mod, lambda sb: qstep(*b, spill_bytes=sb),
                       (spill.GracePartitioner, "read_partition"))
    return 0


def memory_account(torch, entry_mod, run, boundary) -> None:
    """Where an out-of-core step's device memory goes: ``run(None)`` (in
    memory) and ``run(-1)`` (past the entry's budget), each from the bytes
    already allocated (``base``: the inputs the caller holds) and holding
    its output Table. For the spilled run the peak is split at the first
    call of ``boundary`` (owner, name of a generator function: the
    external sort's merge, the Grace join's first partition read): the
    bytes held there and the peak before and after. The output's rows and
    its live, sized and allocated bytes come from
    ``entry.table_device_bytes``. Prints one JSON line ``{"memory": ...}``."""
    import gc
    account = {}
    owner, attr = boundary
    inner = getattr(owner, attr)
    for label, spill_bytes in (("in_memory", None), ("spilled", -1)):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = {}

        def hooked(*a, **kw):
            if not before:
                torch.cuda.synchronize()
                before["peak_above_base"] = \
                    torch.cuda.max_memory_allocated() - base
                before["held_above_base"] = \
                    torch.cuda.memory_allocated() - base
                torch.cuda.reset_peak_memory_stats()
            yield from inner(*a, **kw)
        setattr(owner, attr, hooked)
        try:
            out = run(spill_bytes)
            torch.cuda.synchronize()
        finally:
            setattr(owner, attr, inner)
        after = torch.cuda.max_memory_allocated() - base
        account[label] = {
            "base": base,
            "peak_above_base": max(after, before.get("peak_above_base", 0)),
            "output": entry_mod.table_device_bytes(out)}
        if before:
            account[label]["until_" + attr] = before
            account[label]["peak_above_base_from_" + attr] = after
        del out
    print(json.dumps({"memory": account}))


if __name__ == "__main__":
    sys.exit(main())
