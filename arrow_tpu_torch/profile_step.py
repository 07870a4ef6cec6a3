"""Per-layer device times of one step of the port's slices, on one GPU.

    python -m arrow_tpu_torch.profile_step
        [--path generic|dense|dist|exchange] [--rows N] [--keys N]
        [--max-groups N] [--shards N] [--steps N] [--seed N]

``--path dist`` is the distributed group-by (``entry_distributed``) over
``--shards`` logical shards of the card (default 8), ``--path exchange``
the raw-row exchange (``shuffle_batch`` by the hash of ``k``, buckets of
twice the local capacity) of the same batch (default 4 shards); their
layers are called once per shard and step, and a layer's time is the sum
over the shards.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("generic", "dense", "dist",
                                       "exchange"), default="generic")
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--keys", type=int, default=None)
    ap.add_argument("--max-groups", type=int, default=None,
                    help="state slots (per shard for --path dist); default "
                    "2^22, 2^21 for dist")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 2
    from . import entry as entry_mod
    from .ops import aggregates, cuda_kernels, distinct, grouper, \
        hash_aggregate, selection
    from .parallel import context, dist_agg, shuffle

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
    layer(selection, "rows_of_positions", "rows_of_positions")
    layer(selection, "take_batch", "take_batch")
    layer(selection, "filter_compact_chunks", "B1_filter_compact_chunks")
    layer(HA, "probe_scalars", "probe")
    layer(entry_mod, "_host_probe", "probe_host_read")
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
    layer(shuffle, "partition_for_exchange", "partition_for_exchange")
    layer(shuffle, "hash32", "hash")
    layer(shuffle, "_bucket_rows", "sort_by_dest_and_send_scatter")
    layer(shuffle, "flatten_received", "flatten_received")
    layer(shuffle, "partition_histogram", "B4_partition_histogram")
    layer(shuffle, "exchange", "exchange")
    layer(shuffle, "shuffle_rows_receive", "receive_compaction")
    layer(grouper.Grouper, "consume", "grouper_consume")
    layer(grouper.Grouper, "uniques_scatter", "uniques_scatter")
    for cls in (aggregates.GroupedCount, aggregates.GroupedSum,
                aggregates._GroupedExtremum):
        layer(cls, "merge", f"agg_merge_{cls.name or 'min_max'}")
    layer(grouper, "merge_insert", "merge_insert")
    layer(distinct, "segmented_carry_last", "carry_last_cummax")
    layer(context.DistContext, "_collect_shards", "collect")

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
    else:
        step, (b,) = entry_mod.entry(None, args.rows, args.keys or 1000,
                                     args.seed)
    step(b)
    torch.cuda.synchronize()
    spans.clear()
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
    print(json.dumps({"layers_ms": layers, "host_ms": host_ms}))

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
