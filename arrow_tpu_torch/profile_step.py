"""Per-layer device times of one step of the port's slices, on one GPU.

    python -m arrow_tpu_torch.profile_step
        [--path generic|dense|dist|exchange|sort|join|q3|q3dist] [--rows N]
        [--keys N] [--max-groups N] [--shards N] [--steps N] [--seed N]
        [--build-rows N] [--build-keys N] [--key-dist uniform|zipf]
        [--join-type T] [--wide] [--batch-rows N]

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
per-shard consume and its state-row exchange.

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
                                       "exchange", "sort", "join", "q3",
                                       "q3dist"),
                    default="generic")
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
                    help="state slots (per shard for --path dist and "
                    "q3dist); default 2^22, 2^21 for dist")
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
    from .ops import aggregates, cuda_kernels, distinct, grouper, \
        hash_aggregate, join, selection, sorting
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
    if args.path in ("sort", "join") or (args.path == "dense" and
                                         (args.keys or 0) > 4096):
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
    elif args.path == "q3":
        qstep, tables = entry_mod.entry_q3(
            None, args.rows, args.seed, args.max_groups or 1 << 22,
            args.batch_rows)
        b = tables

        def step(tables_):
            return qstep(*tables_)
    elif args.path == "q3dist":
        qstep, tables = entry_mod.entry_q3_dist(
            None, args.shards or 8, args.rows, args.seed,
            args.max_groups or 1 << 22, args.batch_rows)
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
    else:
        step, (b,) = entry_mod.entry(
            None, args.rows, args.keys or 1000, args.seed,
            args.max_groups or entry_mod.MAX_GROUPS)
    step(b)
    torch.cuda.synchronize()
    spans.clear()
    node_spans.clear()
    node_reads.clear()
    host_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"path {args.path}: {args.rows} rows; host-clock ms per step "
          f"{[round(t, 3) for t in host_ms]}")
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
    # device events only: an operator's own entry repeats its kernels' time
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profiled step: host-clock {wall_ms:.3f} ms, kernels' device "
          f"time {busy_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated()} B; launches "
          f"{dict(cuda_kernels.LAUNCHES)}")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        print(f"  {dev_us(e) / 1e3:10.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
