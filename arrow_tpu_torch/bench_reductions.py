"""Times of the torch primitives the sort-grouping consume chooses between,
at the second slice's shape, on one GPU; and of the exchange's histogram
kernel and the merge's folds at the third slice's shapes.

    python -m arrow_tpu_torch.bench_reductions [--rows N] [--keys N]
                                               [--pack-lanes-only]
                                               [--filter-only]
                                               [--hist-only]

Sorts ``--rows`` int64 keys (half of them inactive) into runs as the
grouper does and times, with CUDA events after a warm-up: the per-run
float64 sum by ``index_add_`` and by ``torch.segment_reduce``; the per-run
int64 minimum by ``scatter_reduce_``; ``cumsum`` and ``cummax`` over the
rows; ``torch.sort`` of the key as int64 and as int32; a gather through the
permutation; ``torch.nonzero``; ``torch.sort`` of full-range random keys by
width (int32 / int64) and stability; ``torch.searchsorted`` of every row
into a sorted table of 2^20 keys beside the merge form of the same find
(the join's two forms). Then the ``partition_histogram`` kernel
beside ``torch.bincount`` and its byte bound over ``--rows`` destinations,
for P = 1, 8, 32, 64, 128 and uniform, one-value and out-of-range
destinations (its time should not depend on them); and an int64
``index_add_`` of 2^24 rows into 2^21 slots, all rows spread against 15/16
of them aimed at one dump slot, as the padding rows of an exchange buffer
are in ``merge_rows``. Last the ``dense_group_reduce`` kernel at the first
slice's call (first_row, sum and min of an f32 column, sum64 and min64 of
an int64 column; 49.5 % of ``--rows`` rows active) for G = 128, 1024, 4096
over key distributions (uniform; every row in one slot; 90 %, 50 %, 25 % of
the rows in one slot; Zipf(1.5)), with the kernel's warp-combined path for
hot slots on and off, and each kind alone at G = 1024. First of all the
``pack_key_lanes`` kernel over ``--rows`` rows for 1, 2, 3, 4, 6 and 12 lanes
beside its byte bound (``--pack-lanes-only`` stops after it: two versions
of the kernel's source are compared by two runs on one machine: the build
is keyed by the sources' hash). ``--filter-only`` times nothing but the
filter kernel B1 at the calls the paths of ``chip_smoke.py`` make (their
row counts, column widths and selectivities), through ``measure_filter``,
the function ``chip_smoke.py`` times B1 with: ``filter_compact_columns``
compared once with its plain version, ``ms`` over ten back-to-back calls
as the events see them, ``device_ms`` over ten calls queued behind a
``torch.cuda._sleep`` (the card's time alone, whatever the host's),
``host_ms`` the host's time to issue one call, the byte bound, the plain
version, ``chunks[sel]`` and one ``c[sel]`` per column. Beside it the same
columns as u8 planes side by side through ``filter_compact_chunks``, the
one-matrix form (``chunks_ms``, ``chunks_device_ms``): the form the
filter layer called before the column form existed, so this script, run on
an earlier tree (copied into it), times that tree's kernel at the same
calls; there, with no ``filter_compact_columns``, only this form is timed.
``--hist-only`` times nothing but the exchange's kernels, B4
(``partition_histogram_segments``) and ``partition_positions``, at the
calls the distributed paths make, one call a shuffle over all its shards
on the card, through ``measure_hist`` and ``measure_positions`` (which
``chip_smoke.py`` times them with too): the state-row exchange of path 3a
(8 x 2^21 rows), path 3b's shuffle (4 x 25M rows, P 4), a lineitem
batch's shuffle (8 x 2^19 rows) and the state-row exchange (8 x 2^22) of
path 7b, the shuffles of paths 7c and 7d (8 x 3,125,000 rows), and B4 at
100M rows; B4 also at one shard of each; each compared once with its
plain version, then ``ms`` over ten back-to-back calls, ``device_ms`` the
same queued behind a sleep (the card's time alone), ``host_ms``, the byte
bound, the plain version and one library call over all the shards' rows:
``torch.bincount`` for B4, a stable ``torch.sort`` (what the exchange ran
before the positions kernel) for ``partition_positions``. One line per primitive, then one JSON object. Needs a CUDA device; the
numbers in ``PERF.md`` that name this script come from it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)


def cuda_ms(torch, fn, reps: int, queued: bool = False) -> float:
    """Mean device time of fn over reps runs, after one warm-up run.
    ``queued``: the runs are queued behind a ``torch.cuda._sleep`` of some
    0.1 s, so that the card runs them back to back whatever the host's
    time to issue one: the card's time alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int = 10) -> float:
    """The host's time to issue one run of fn (the card not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def fc_widths(columns):
    """Bytes a row of each column of a filter_compact_columns call."""
    return [c.shape[1] if c.ndim == 2 else c.element_size() for c in columns]


def fc_planes(torch, columns):
    """The columns as u8 planes side by side: the one-matrix form's input."""
    cap = columns[0].shape[0]
    return torch.cat([c.contiguous().view(torch.uint8).reshape(cap, -1)
                      for c in columns], dim=1)


def check_filter(torch, ck, sel, columns, label: str) -> float:
    """B1 (``filter_compact_columns``) vs its plain version: the same count
    on the device, every column's first count rows equal byte for byte.
    Returns the max abs difference over those bytes (0 when equal); raises
    on any difference."""
    outs, count = ck.filter_compact_columns(sel, columns)
    want, want_count = ck.filter_compact_columns_plain(sel, columns)
    n = int(want_count)
    if count.dtype != torch.int32 or int(count) != n:
        raise RuntimeError(f"check failed: filter_compact_columns {label}: "
                           f"count {int(count)}, plain {n}")
    err = 0.0
    for got, w in zip(outs, want):
        if got.dtype != w.dtype or got.shape != w.shape:
            raise RuntimeError(f"check failed: filter_compact_columns "
                               f"{label}: an output's type or shape")
        a, b = got[:n].view(torch.uint8), w[:n].view(torch.uint8)
        if not torch.equal(a, b):
            err = max(err, float((a.int() - b.int()).abs().max()))
    if err:
        raise RuntimeError(f"check failed: filter_compact_columns {label}: "
                           "rows differ")
    print(f"filter_compact_columns {label}: cap={sel.shape[0]} widths="
          f"{fc_widths(columns)} selected={n} equal")
    return err


def measure_filter(torch, ck, sel, columns, label: str) -> dict:
    """B1 (``filter_compact_columns``) at the arguments a path gave it:
    compared with its plain version, then timed: ``ms`` the wrapper as the
    path runs it, ``device_ms`` the same calls queued behind a sleep (the
    card's time alone); beside them the plain version, the bound,
    ``chunks[sel]`` on the same columns packed as u8 planes side by side
    (the JAX caller's form and the earlier slices' kernel input:
    ``library_ms``) and one ``c[sel]`` per column (``columns_index_ms``).
    ``host_ms`` is the host's time to issue one call: where it reaches
    ``ms`` the events read the wrapper, not the kernel."""
    cap = sel.shape[0]
    widths = fc_widths(columns)
    width = sum(widths)
    n = int(sel.sum())

    def call():
        return ck.filter_compact_columns(sel, columns)
    m = {"max_abs_err": check_filter(torch, ck, sel, columns, label),
         "ms": cuda_ms(torch, call, 10),
         "device_ms": cuda_ms(torch, call, 10, queued=True),
         "plain_ms": cuda_ms(torch, lambda: ck.filter_compact_columns_plain(
             sel, columns), 3),
         # selection and columns read once, the selected rows written once
         "bound_ms": (cap + cap * width + n * width) / HBM_BYTES_PER_S * 1e3}
    chunks = fc_planes(torch, columns)
    m["library_ms"] = cuda_ms(torch, lambda: chunks[sel], 3)
    del chunks
    # torch has no mask index for uint16 / uint32 / uint64 on the card
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    flat = [c if c.ndim == 2 else c.view(signed[c.element_size()])
            for c in columns]
    m["columns_index_ms"] = cuda_ms(torch, lambda: [c[sel] for c in flat], 3)
    m["host_ms"] = host_ms(torch, call)
    m["widths"] = widths
    print(f"filter_compact_columns {label}: cap={cap} widths={widths} "
          f"selected={n}: {m['ms']:.4f} ms, the card alone "
          f"{m['device_ms']:.4f} ms ({m['host_ms']:.4f} ms of host a call), "
          f"bound {m['bound_ms']:.4f} ms, plain {m['plain_ms']:.3f} ms, "
          f"chunks[sel] {m['library_ms']:.4f} ms, per-column c[sel] "
          f"{m['columns_index_ms']:.4f} ms")
    return m


def _segment_keys(torch, dests, P: int):
    """The segments' dests as one int32 vector with the segment folded into
    the value (s * (P + 1) + dest, dest outside [0, P) as P): the input of
    one library call over all of them, made outside its timing."""
    return torch.cat([
        s * (P + 1) + torch.where((d >= 0) & (d < P), d, P)
        for s, d in enumerate(dests)]).to(torch.int32)


def measure_hist(torch, ck, dests, P: int, label: str) -> dict:
    """B4 (``partition_histogram_segments``) at the arguments a path gave
    it, one dest vector a shard of the call: equal to its plain version
    (counts and tile offsets; raises if not), then timed as
    ``measure_filter`` times B1: ``ms`` back to back, ``device_ms`` the
    card alone, ``host_ms`` the host's time to issue one call; beside them
    the plain version, one ``torch.bincount`` over all the shards' rows
    with the shard folded into the bin (``library_ms``) and the bound (the
    dests read once, the counts and tile offsets written once)."""
    dests = list(dests)
    got = ck.partition_histogram_segments(dests, P)
    want = ck.partition_histogram_segments_plain(dests, P)
    if any(g.dtype != w.dtype or not torch.equal(g, w)
           for g, w in zip(got, want)):
        raise RuntimeError(f"check failed: partition_histogram {label}: "
                           f"{got[0].tolist()} against {want[0].tolist()}")
    n = sum(d.shape[0] for d in dests)
    keys = _segment_keys(torch, dests, P)

    def call():
        return ck.partition_histogram_segments(dests, P)
    m = {"max_abs_err": 0.0,
         "ms": cuda_ms(torch, call, 10),
         "device_ms": cuda_ms(torch, call, 10, queued=True),
         "host_ms": host_ms(torch, call),
         "plain_ms": cuda_ms(
             torch, lambda: ck.partition_histogram_segments_plain(dests, P),
             3),
         "bound_ms": (4 * n + 4 * got[0].numel() + 4 * got[1].numel()) /
         HBM_BYTES_PER_S * 1e3,
         "library_ms": cuda_ms(
             torch, lambda: torch.bincount(keys, minlength=len(dests) *
                                           (P + 1)), 3),
         "rows": n, "segments": len(dests)}
    print(f"partition_histogram {label}, {len(dests)} x "
          f"{dests[0].shape[0]} rows, P={P} counted={int(want[0].sum())} "
          f"equal: {m['ms']:.4f} ms, the card alone {m['device_ms']:.4f} ms "
          f"({m['host_ms']:.4f} ms of host a call), bound "
          f"{m['bound_ms']:.4f} ms, plain {m['plain_ms']:.3f} ms, "
          f"torch.bincount {m['library_ms']:.3f} ms")
    return m


def measure_positions(torch, ck, dests, P: int, B: int, label: str) -> dict:
    """``partition_positions`` at the arguments a path gave it: equal to
    its plain version (raises if not), then timed as ``measure_hist``;
    beside it the plain version, one stable ``torch.sort`` of all the
    shards' rows with the shard folded into the value (``library_ms``: the
    sort the exchange ran before this kernel) and the bound (the dests and
    the tile offsets read once, the int64 slots written once)."""
    dests = list(dests)
    _, tiles = ck.partition_histogram_segments(dests, P)
    got = ck.partition_positions(dests, P, B, tiles)
    want = ck.partition_positions_plain(dests, P, B)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"check failed: partition_positions {label}")
    n = sum(d.shape[0] for d in dests)
    keys = _segment_keys(torch, dests, P)

    def call():
        return ck.partition_positions(dests, P, B, tiles)
    m = {"max_abs_err": 0.0,
         "ms": cuda_ms(torch, call, 10),
         "device_ms": cuda_ms(torch, call, 10, queued=True),
         "host_ms": host_ms(torch, call),
         "plain_ms": cuda_ms(
             torch, lambda: ck.partition_positions_plain(dests, P, B), 3),
         "bound_ms": (4 * n + 4 * tiles.numel() + 8 * n) /
         HBM_BYTES_PER_S * 1e3,
         "library_ms": cuda_ms(
             torch, lambda: torch.sort(keys, stable=True), 3),
         "rows": n, "segments": len(dests)}
    print(f"partition_positions {label}, {len(dests)} x {dests[0].shape[0]} "
          f"rows, P={P} B={B} equal: {m['ms']:.4f} ms, the card alone "
          f"{m['device_ms']:.4f} ms ({m['host_ms']:.4f} ms of host a call), "
          f"bound {m['bound_ms']:.4f} ms, plain {m['plain_ms']:.3f} ms, "
          f"torch.sort {m['library_ms']:.3f} ms")
    return m


def bench_hist(torch, ck, dev, gen, results) -> None:
    """B4 and ``partition_positions`` at the distributed paths' calls; see
    the module's docstring."""
    # (label, shards, rows a shard, P, share of the rows with a destination)
    calls = [("path_3a_state_rows", 8, 1 << 21, 8, 0.48),
             ("path_3b_shuffle", 4, 25_000_000, 4, 1.0),
             ("path_7b_probe_shuffle", 8, 1 << 19, 8, 0.59),
             ("path_7b_state_rows", 8, 1 << 22, 8, 0.3),
             ("path_7c_probe_shuffle", 8, 3_125_000, 8, 1.0),
             ("path_7d_sort_shuffle", 8, 3_125_000, 8, 1.0),
             ("rows_100M", 1, 100_000_000, 8, 1.0)]
    for label, S, n, P, share in calls:
        dests = []
        for _ in range(S):
            d = torch.randint(0, P, (n,), generator=gen, device=dev,
                              dtype=torch.int32)
            dests.append(torch.where(
                torch.rand(n, generator=gen, device=dev) < share, d, P))
        for k, v in measure_hist(torch, ck, dests, P, label).items():
            results[f"hist_{label}_{k}"] = v
        for k, v in measure_hist(torch, ck, dests[:1], P,
                                 label + "_one_shard").items():
            results[f"hist_{label}_one_shard_{k}"] = v
        if label != "rows_100M":
            # the bucket capacity of a shuffle of raw rows: the local rows
            for k, v in measure_positions(torch, ck, dests, P, n,
                                          label).items():
                results[f"positions_{label}_{k}"] = v
        del dests


def bench_filter(torch, ck, dev, gen, results) -> None:
    """B1 at the paths' calls; see the module's docstring."""
    def column(cap, width):
        dtype = {4: torch.float32, 8: torch.int64}[width]
        return torch.randint(-(1 << 30), 1 << 30, (cap,), generator=gen,
                             device=dev).to(dtype)

    # (label, rows, column widths, selected share or count)
    calls = [("path_1", 100_000_000, (8, 4, 8), 0.495),
             ("path_3a", 12_500_000, (8, 8, 8), 0.495),
             ("path_5c_left_semi", 10_000_000, (8, 4), 0.25),
             ("path_5c_finish", 1 << 20, (8,), 123),
             ("path_6", 1 << 22, (8, 4, 4, 4), 0.59),
             ("path_6b_bloom_split", 1 << 22, (8, 8, 4), 0.23)]
    for label, cap, widths, share in calls:
        cols = [column(cap, w) for w in widths]
        if share >= 1:
            sel = torch.zeros(cap, dtype=torch.bool, device=dev)
            sel[torch.randperm(cap, generator=gen, device=dev)[:share]] = 1
        else:
            sel = torch.rand(cap, generator=gen, device=dev) < share
        r = {}
        if hasattr(ck, "filter_compact_columns"):
            r = measure_filter(torch, ck, sel, cols, label)
            del r["widths"]
        chunks = fc_planes(torch, cols)
        n = int(sel.sum())
        if not torch.equal(ck.filter_compact_chunks(sel, chunks)[:n],
                           ck.filter_compact_chunks_plain(sel, chunks)[:n]):
            raise RuntimeError(f"filter_compact_chunks differs at {label}")

        def call():
            return ck.filter_compact_chunks(sel, chunks)
        r["chunks_ms"] = cuda_ms(torch, call, 10)
        r["chunks_device_ms"] = cuda_ms(torch, call, 10, queued=True)
        r["chunks_host_ms"] = host_ms(torch, call)
        for k, v in r.items():
            results[f"filter_{label}_{k}"] = v
        print(f"filter {label:24s} one matrix of {chunks.shape[1]} B: "
              f"{r['chunks_ms']:8.4f} ms, device "
              f"{r['chunks_device_ms']:8.4f}, host "
              f"{r['chunks_host_ms']:8.4f}")
        del cols, sel, chunks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--keys", type=int, default=3_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pack-lanes-only", action="store_true")
    ap.add_argument("--filter-only", action="store_true")
    ap.add_argument("--hist-only", action="store_true")
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

    results = {"rows": n}

    def report(name, fn, reps: int = 3):
        results[name], out = ms(fn, reps)
        print(f"{name:40s} {results[name]:10.3f} ms")
        return out

    from .ops import cuda_kernels as ck
    if args.filter_only:
        bench_filter(torch, ck, dev, gen, results)
        print(json.dumps(results))
        return 0
    if args.hist_only:
        bench_hist(torch, ck, dev, gen, results)
        print(json.dumps(results))
        return 0

    # the join's key packing by lane count: every lane and the flag read
    # once, the keys written once
    flag = torch.rand(n, generator=gen, device=dev) < 0.9
    lanes = []
    for L in (1, 2, 3, 4, 6, 12):
        while len(lanes) < L:
            lanes.append(torch.randint(0, 1 << 10, (n,), generator=gen,
                                       device=dev))
        lo = torch.full((L,), 8, dtype=torch.int64, device=dev)
        span = torch.full((L,), 1000, dtype=torch.int64, device=dev)
        shift = torch.arange(L, device=dev) * 10
        results[f"pack_key_lanes_L{L}_bound"] = \
            n * (8 * L + 1 + 8) / 3.35e12 * 1e3
        got = report(f"pack_key_lanes_L{L}", lambda: ck.pack_key_lanes(
            lanes[:L], lo, span, shift, flag), reps=10)
        if not torch.equal(got, ck.pack_key_lanes_plain(
                lanes[:L], lo, span, shift, flag)):
            raise RuntimeError(f"pack_key_lanes differs at {L} lanes")
        print(f"{'  bound':40s} "
              f"{results[f'pack_key_lanes_L{L}_bound']:10.3f} ms")
    del lanes, flag, got
    if args.pack_lanes_only:
        print(json.dumps(results))
        return 0

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

    results.update(runs=n_runs, slots=R)
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
    # the sort and the join's find: full-range random keys by width, stable
    # or not; a binary search of every row in a sorted 2^20-entry table
    # against the merge form of the same find (table and rows sorted
    # together, a cumsum, a scatter back)
    full64 = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                           device=dev)
    full32 = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen,
                           device=dev, dtype=torch.int32)
    for name, k_ in (("i64", full64), ("i32", full32)):
        for stable in (True, False):
            report(f"sort_full_range_{name}_{'stable' if stable else 'unstable'}",
                   lambda: torch.sort(k_, stable=stable))
    table = torch.sort(torch.randperm(1 << 22, generator=gen, device=dev)
                       [:1 << 20]).values
    probe = torch.randint(0, 1 << 22, (n,), generator=gen, device=dev)
    report("searchsorted_into_2^20_i64", lambda: torch.searchsorted(
        table, probe))
    report("searchsorted_into_2^20_i64_out_i32", lambda: torch.searchsorted(
        table, probe, out_int32=True))

    def merge_form():
        keyv = torch.cat([table << 1, (probe << 1) | 1])
        skey_, order = torch.sort(keyv)
        isb = (skey_ & 1) == 0
        bseg = torch.cumsum(isb, 0) - 1
        out = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        return out.index_copy_(0, torch.where(isb, n, order - (1 << 20)),
                               bseg)
    report("merge_find_into_2^20_i64", merge_form)
    del full64, full32, table, probe
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
    del ones, spread, dumped, idx

    act = int(n * 0.495)
    v = torch.randn(n, generator=gen, device=dev)
    w = torch.randint(1, 100, (n,), generator=gen, device=dev)
    streams = {"sum": v, "min": v, "sum64": w, "min64": w}
    kinds = ("first_row", "sum", "min", "sum64", "min64")

    def gids(nkeys, dist):
        """(n,) int32: the first ``act`` rows active, by distribution."""
        gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if dist == "zipf_1.5":
            p = 1.0 / torch.arange(1, nkeys + 1, dtype=torch.float64,
                                   device=dev) ** 1.5
            u = torch.rand(act, generator=gen, device=dev,
                           dtype=torch.float64)
            gid[:act] = torch.searchsorted(
                torch.cumsum(p / p.sum(), 0), u).clamp(max=nkeys - 1)
            return gid
        gid[:act] = torch.randint(0, nkeys, (act,), generator=gen,
                                  device=dev, dtype=torch.int32)
        share = {"uniform": 0.0, "one_slot": 1.0}.get(dist)
        if share is None:
            share = float(dist.split("_")[0]) / 100
        hot = torch.rand(act, generator=gen, device=dev) < share
        gid[:act][hot] = 7
        return gid

    def dg(gid, G, sub=kinds):
        return ck.dense_group_reduce(
            gid, tuple(streams[k] for k in sub if k in streams), sub, G)

    hot_rows = ck._DG_HOT_ROWS
    try:
        for G, nkeys in ((128, 100), (1024, 1000), (4096, 4000)):
            for dist in ("uniform", "one_slot", "90_hot", "50_hot", "25_hot",
                         "zipf_1.5"):
                gid = gids(nkeys, dist)
                for label, threshold in (("", hot_rows),
                                         ("_no_hot_path", 129)):
                    ck._DG_HOT_ROWS = threshold
                    report(f"dense_group_G{G}_{dist}{label}",
                           lambda: dg(gid, G))
                if G == 1024 and dist == "uniform":
                    ck._DG_HOT_ROWS = hot_rows
                    report(f"dense_group_G{G}_only_rows",
                           lambda: dg(gid, G, ()))
                    for kind in kinds:
                        report(f"dense_group_G{G}_only_{kind}",
                               lambda: dg(gid, G, (kind,)))
    finally:
        ck._DG_HOT_ROWS = hot_rows
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
