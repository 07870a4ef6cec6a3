"""Times of the torch primitives the sort-grouping consume chooses between,
at the second slice's shape, on one GPU; and of the exchange's histogram
kernel and the merge's folds at the third slice's shapes.

    python -m arrow_tpu_torch.bench_reductions [--rows N] [--keys N]

Sorts ``--rows`` int64 keys (half of them inactive) into runs as the
grouper does and times, with CUDA events after a warm-up: the per-run
float64 sum by ``index_add_`` and by ``torch.segment_reduce``; the per-run
int64 minimum by ``scatter_reduce_``; ``cumsum`` and ``cummax`` over the
rows; ``torch.sort`` of the key as int64 and as int32; a gather through the
permutation; ``torch.nonzero``. Then the ``partition_histogram`` kernel
beside ``torch.bincount`` and its byte bound over ``--rows`` destinations,
for P = 1, 8, 32, 64, 128 and uniform, one-value and out-of-range
destinations (its time should not depend on them); and an int64
``index_add_`` of 2^24 rows into 2^21 slots, all rows spread against 15/16
of them aimed at one dump slot, as the padding rows of an exchange buffer
are in ``merge_rows``. One line per primitive, then one JSON object. Needs a CUDA device; the numbers in ``PERF.md`` that name this
script come from it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--keys", type=int, default=3_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_reductions: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    n = args.rows
    sentinel = 0xFFFFFFFF
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    active = torch.rand(n, generator=gen, device=dev) < 0.495
    key = torch.where(active, torch.randint(0, args.keys, (n,), generator=gen,
                                            device=dev), sentinel)
    skey, perm = torch.sort(key, stable=True)
    s_active = skey != sentinel
    head = s_active & torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev), skey[1:] != skey[:-1]])
    seg = torch.cumsum(head, 0) - 1
    n_active = int(s_active.sum())
    n_runs = int(seg[n_active - 1]) + 1
    R = 1 << (n_runs - 1).bit_length()
    slot = torch.where(s_active, seg, R)
    offsets = torch.full((R + 1,), n_active, dtype=torch.int64, device=dev)
    offsets[:n_runs] = torch.nonzero(head).flatten()
    x = torch.where(s_active, torch.randn(n, generator=gen, device=dev,
                                          dtype=torch.float64), 0.0)
    w = torch.randint(-100, 100, (n,), generator=gen, device=dev)
    i32 = seg.to(torch.int32)

    def ms(fn, reps: int = 3):
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out

    results = {"rows": n, "runs": n_runs, "slots": R}

    def report(name, fn):
        results[name], out = ms(fn)
        print(f"{name:34s} {results[name]:10.3f} ms")
        return out

    by_add = report("sum_f64_index_add", lambda: torch.zeros(
        R + 1, dtype=torch.float64, device=dev).index_add_(0, slot, x))
    by_seg = report("sum_f64_segment_reduce", lambda: torch.segment_reduce(
        x, "sum", offsets=offsets, unsafe=True))
    results["sum_max_abs_diff"] = float(
        (by_add[:n_runs] - by_seg[:n_runs]).abs().max())
    report("min_i64_scatter_reduce", lambda: torch.full(
        (R + 1,), 1 << 62, dtype=torch.int64, device=dev).scatter_reduce_(
        0, slot, w, "amin"))
    report("cumsum_i64", lambda: torch.cumsum(w, 0))
    report("cumsum_i32", lambda: torch.cumsum(i32, 0, dtype=torch.int32))
    report("cummax_i64", lambda: torch.cummax(w, 0))
    report("cummax_i32", lambda: torch.cummax(i32, 0))
    report("sort_i64", lambda: torch.sort(key, stable=True))
    key32 = (key - (1 << 31)).to(torch.int32)        # same order in 32 bits
    report("sort_i32", lambda: torch.sort(key32, stable=True))
    report("gather_f64_by_perm", lambda: x[perm])
    report("nonzero", lambda: torch.nonzero(active))
    del key, skey, perm, x, w, i32, key32, slot, seg, head, s_active, active

    from .ops.cuda_kernels import partition_histogram
    results["partition_histogram_bound"] = 4 * n / 3.35e12 * 1e3
    print(f"{'partition_histogram_bound':34s} "
          f"{results['partition_histogram_bound']:10.3f} ms")
    for P in (1, 8, 32, 64, 128):
        for name, dest in (
                ("uniform", torch.randint(0, P, (n,), generator=gen,
                                          device=dev, dtype=torch.int32)),
                ("one_value", torch.zeros(n, dtype=torch.int32, device=dev)),
                ("out_of_range", torch.full((n,), P, dtype=torch.int32,
                                            device=dev))):
            report(f"partition_histogram_P{P}_{name}",
                   lambda: partition_histogram(dest, P))
            report(f"bincount_P{P}_{name}",
                   lambda: torch.bincount(dest, minlength=P))
    del dest

    G, rows = 1 << 21, 1 << 24
    ones = torch.ones(rows, dtype=torch.int64, device=dev)
    spread = torch.randint(0, G, (rows,), generator=gen, device=dev)
    dumped = torch.where(torch.arange(rows, device=dev) < rows // 16,
                         spread, G)
    for name, idx in (("spread", spread), ("15_of_16_to_dump_slot", dumped)):
        report(f"index_add_i64_{name}", lambda: torch.zeros(
            G + 1, dtype=torch.int64, device=dev).index_add_(0, idx, ones))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
