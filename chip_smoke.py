#!/usr/bin/env python3
"""Smoke test of the PyTorch port (arrow_tpu_torch) on one NVIDIA GPU.

Builds the CUDA kernels from csrc/, checks each kernel against its plain
PyTorch version on the card, then drives the slices of the port at 100M
rows (BASELINE config #2) and checks each result against a numpy oracle:

  path 1  ``arrow_tpu_torch.entry.entry``: compaction-kernel filter ->
          dense group-by kernel (1K distinct int64 keys, float32 values);
  path 2  ``arrow_tpu_torch.entry.entry_generic``: take-index filter on the
          tile-compaction and tile-stitch kernels -> sort-grouping consume
          (3M distinct keys, float64 values, 4M-slot state);
  path 3a ``arrow_tpu_torch.entry.entry_distributed``: the distributed
          group-by over 8 logical shards of the card (1M distinct keys):
          per-shard filter + pre-aggregation, state-row exchange on the
          partition-histogram kernel, merge;
  path 3b ``arrow_tpu_torch.parallel.shuffle.shuffle_batch``: the raw-row
          exchange of the same batch by key hash over 4 logical shards,
          and one shard's send side of the same exchange over 8;
  path 4  ``arrow_tpu_torch.entry.entry_sort`` (BASELINE config #3): a
          two-key stable sort of 100M rows (int64 ascending, int32 with 5 %
          nulls descending, nulls last) and the take through it. Cut
          against config #3: the second key is an int32, not a
          dictionary-encoded string (varlen and dictionary columns are not
          ported yet);
  path 5a ``arrow_tpu_torch.entry.entry_join`` (BASELINE config #4): inner
          join of a 100M-row probe side against 2^20 unique build keys, a
          quarter of the probe rows matching (route "packed_u");
  path 5b the same with Zipf(1.5)-skewed probe keys (every row matches);
  path 5c the other routes at 10M probe rows: duplicate build keys
          ("packed"), two wide keys ("sort"), and left semi / left anti /
          full outer + finish on the packed route;
  path 1b path 1 with 100,000 distinct keys: the sorted dense reduction;
  path 6  ``arrow_tpu_torch.entry.entry_q3`` (BASELINE config #5): the
          Q3-shaped Declaration (filter -> hashjoin -> hashjoin -> project
          -> aggregate -> order_by -> fetch) through the plan engine over
          100M lineitem, 25M orders and 2.5M customer rows in 2^22-row
          batches, against a numpy oracle; per plan node its device ms and
          host reads. Cut against config #5: 100M lineitem rows, not SF100's
          600M; one card, no ``dist=``; dates and the segment are int32
          codes, not dictionary strings;
  path 6b a table_source -> filter -> hashjoin Declaration on two wide
          int64 keys (2^20 build x 10M probe rows, the "sort" route), which
          runs the Bloom pushdown;
  path 7b path 6's Declaration on path 6's tables with ``dist=`` over 8
          logical shards of the card: both joins ``DistHashJoin``, the
          aggregate the state-row exchange, against path 6's oracle;
  path 7a ``arrow_tpu_torch.entry.dryrun_multichip`` over 8 logical
          shards: distributed group-by, join, sort, one hot key and the Q3
          Declaration with ``dist=``, each against numpy or pyarrow;
  path 7c ``arrow_tpu_torch.entry.entry_dist_join``: ``DistContext.join``
          inner of 2^20 build rows and 25M probe rows (config #4's shape,
          the probe cut from 100M: the raw-row exchange's buffers);
  path 7d ``arrow_tpu_torch.entry.entry_dist_sort``: ``DistContext.sort_by``
          of config #3's columns at 25M rows (cut from 100M as 7c is).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

The filter kernel B1 (``filter_compact_columns``: one launch compacts a
batch's columns as they lie) is held against its plain version first on
synthetic calls (every column width in one launch, caps that end mid
tile, misaligned and strided views, 70 columns in three launches, the
one-matrix form ``filter_compact_chunks`` up to 100M x 20 B), then at every
call paths 1, 1b, 3a, 5c, 6, 6b and 7a-7d make to it. The exchange's
two kernels, the partition histogram B4 (``partition_histogram_segments``:
counts and tile offsets) and ``partition_positions`` (every row's slot in
its bucket), are held against their plain versions on synthetic calls
(one segment and eight of unequal lengths, misaligned views, buckets
that hold all, some and none of the rows), then at every call paths 3a,
3b and 7a-7d make to them: ONE launch of each a shuffle over all the
shards of the card, and no ``torch.sort`` inside the exchange's
``_bucket_rows``. Paths 7a-7d hold every call they make to B1, the two
exchange kernels and the key packing against its plain version, and the
launches those calls make against their counted runs'.

Prints the card's name and power limit, one line per check, a JSON line
``{"paths": {...}}`` (each path's counted step: ms and peak device bytes;
path 1 also its filter layer's device ms, the expression excluded), a JSON
line ``{"kernels": [...]}`` (the four kernels that stand for the JAX package's
Pallas kernels, the tile stitch and the join's key packing, which stand for
passes it leaves to XLA, and the bucket positions, which stand for its
exchange's stable sort by destination) with each kernel's launches on its path's counted
run and, at the arguments that path gave it, its error against the plain
version, its time, the plain version's, the least time the card could take
(``bound_ms``: bytes moved over the memory rate) and the time of one
PyTorch call computing the same function (``library_ms``, null where there
is none); a kernel that further paths launch carries the same numbers at
their arguments under suffixed keys (``ms_path_3b``,
``ms_path_5c_left_semi`` ...: every call path 5c's semi, anti and outer
joins make is held against the plain version too, and every call of path
6's four kernels), and the dense group-by
kernel also those of the twelve-stream call the earlier slices made
(``ms_nine_kinds`` ...). B1's entries also carry, at each call,
``device_ms`` (the calls queued behind a sleep: the card's time alone;
``arrow_tpu_torch.bench_reductions.measure_filter`` times them), ``host_ms``
(the host's time to issue one call), ``columns_index_ms`` (one ``c[sel]``
per column; its ``library_ms`` is ``chunks[sel]`` on the columns packed as
u8 planes side by side, the JAX caller's form) and ``widths`` (the bytes a
row of each column); B4's and ``partition_positions``' the same
``device_ms`` and ``host_ms``, and ``rows`` and ``segments`` (the call's
shards). Last comes
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when there is no
CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

try:
    from arrow_tpu_torch.bench_reductions import (
        HBM_BYTES_PER_S, check_filter, cuda_ms, fc_widths, measure_filter,
        measure_hist, measure_positions)
except ImportError as e:
    sys.exit(f"chip_smoke: arrow_tpu_torch not importable ({e}); run from "
             "the repository root")

N_ROWS = 100_000_000
NUM_KEYS = 1000
# f32 sums: atomics and numpy's float64 bincount add in other orders
SUM_RTOL = 1e-5         # times the sum of |x| in the slot
SUM_ATOL_KERNEL = 1e-6  # kernel vs plain version
SUM_ATOL_SLICE = 1e-3   # slice vs numpy oracle
# path 2
NUM_KEYS_GENERIC = 3_000_000
MAX_GROUPS_GENERIC = 1 << 22
# f64 sums: the port adds each group's rows in sorted order, numpy's
# bincount in input order
SUM64_RTOL = 1e-12      # times the sum of |v| in the group
SUM64_ATOL = 1e-12
# path 3
NUM_KEYS_DIST = 1_000_000
N_SHARDS = 8
MAX_GROUPS_PER_SHARD = 1 << 21
# The raw-row exchange allocates, per shard, send and receive buffers of
# P * B = 2 * N_ROWS rows per leaf (B = 2 x the local capacity) and a result
# of the same capacity: 4.8 GB each at 24 B a row. With 8 shards the send
# buffers and the results alone are 77 GB, so path 3b runs 4 shards; rows,
# keys and the bucket factor are not cut.
N_SHARDS_RAW = 4
# path 4 (sort) and path 5 (join)
NUM_KEYS_SORT = 1_000_000
N_BUILD = 1 << 20
N_PROBE_ROUTES = 10_000_000     # path 5c's probe depth
BUILD_KEYS_DUP = 1 << 18        # path 5c: 2^20 build rows over 2^18 keys
# path 1b
NUM_KEYS_SORTED_DENSE = 100_000
MAX_GROUPS_SORTED_DENSE = 1 << 17
# path 6 (BASELINE #5 cut to 100M lineitem rows) and 6b
N_LINEITEM = 100_000_000
Q3_BATCH_ROWS = 1 << 22         # the JAX package's Q3 bench (bench.py)
Q3_MAX_GROUPS = 1 << 22         # holds path 6's ~3.8M groups: no replay
BLOOM_LV_MIN = -1.0             # path 6b's probe filter keeps 84 % of rows
# paths 7c (BASELINE #4's join) and 7d (BASELINE #3's sort) over 8 logical
# shards. The raw-row exchange holds, per side, (P, B) send buffers, their
# stacked receive and its compaction: 2n x the local capacity rows each
# (3n x for the sort's bucket factor 3), so 100M probe rows would need
# about 66 GB and 100M sort rows 150 GB: both run 25M rows (ROADMAP P5,
# buffers sized by the counts, would lift the cut)
N_PROBE_DIST = 25_000_000
N_SORT_DIST = 25_000_000
SORT_BUCKET_FACTOR = 3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(n_bytes: int) -> float:
    """Least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def check_tile_compact(torch, ck, sel, label: str) -> float:
    """Kernel vs plain version: equal loc (zeros past each tile's count
    included) and equal counts. Returns the max abs difference."""
    loc, counts = ck.tile_compact_local(sel)
    ploc, pcounts = ck.tile_compact_local_plain(sel)
    err = 0.0
    if sel.shape[0]:
        err = float(max((loc - ploc).abs().max(),
                        (counts - pcounts).abs().max()))
    check(err == 0 and torch.equal(loc, ploc) and
          torch.equal(counts, pcounts),
          f"tile_compact_local {label}: loc or counts differ")
    print(f"tile_compact_local {label}: cap={sel.shape[0]} "
          f"selected={int(counts.sum())} equal")
    return err


def check_tile_stitch(torch, ck, sel, out_cap: int, label: str) -> float:
    """tile_stitch against its plain version on tile_compact_local's output
    for ``sel``: equal over all ``out_cap`` slots. Returns the max abs
    difference."""
    loc, counts = ck.tile_compact_local(sel)
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    got = ck.tile_stitch(loc, counts, starts, out_cap)
    want = ck.tile_stitch_plain(loc, counts, starts, out_cap)
    err = float((got - want).abs().max())
    check(err == 0 and got.dtype == torch.int32 and
          got.shape == (out_cap,), f"tile_stitch {label}: indices differ")
    print(f"tile_stitch {label}: cap={sel.shape[0]} out_cap={out_cap} "
          f"selected={int(starts[-1])} equal")
    return err


def selection_cases(torch, cap: int, gen, dev):
    """(label, sel) cases of a (cap,) selection, cap a multiple of 1024:
    none, all, half, and 30 % with every other stretch of 8 tiles empty."""
    yield "none", torch.zeros(cap, dtype=torch.bool, device=dev)
    yield "all", torch.ones(cap, dtype=torch.bool, device=dev)
    yield "half", torch.rand(cap, generator=gen, device=dev) < 0.5
    sel = torch.rand(cap, generator=gen, device=dev) < 0.3
    tile = torch.arange(cap, device=dev, dtype=torch.int32) // 1024
    yield "empty stretches", sel & ((tile // 8) % 2 == 1)


def check_take_indices(torch, selection, Array, bool_type, sel,
                       label: str) -> None:
    """get_take_indices (both kernels) vs torch.nonzero."""
    idx = selection.get_take_indices(Array(bool_type, sel))
    want = torch.nonzero(sel).flatten()
    n = want.shape[0]
    check(int(idx.length) == n, f"get_take_indices {label}: count")
    check(torch.equal(idx.values[:n].long(), want),
          f"get_take_indices {label}: indices")
    check(not bool(idx.values[n:].any()),
          f"get_take_indices {label}: padding rows")
    print(f"get_take_indices {label}: cap={sel.shape[0]} selected={n} "
          "equal to torch.nonzero")


def check_filter_chunks(torch, ck, sel, chunks, label: str) -> None:
    """The one-matrix form (``filter_compact_chunks``) vs its plain
    version: the same first count rows."""
    n = int(sel.sum())
    check(torch.equal(ck.filter_compact_chunks(sel, chunks)[:n],
                      ck.filter_compact_chunks_plain(sel, chunks)[:n]),
          f"filter_compact_chunks {label}: rows differ")
    print(f"filter_compact_chunks {label}: cap={sel.shape[0]} "
          f"C={chunks.shape[1]} selected={n} equal")


def check_partition_hist(torch, ck, dest, P: int, label: str) -> float:
    """Kernel vs plain version: equal counts. Returns the max abs
    difference (0 when equal)."""
    before = ck.LAUNCHES["partition_histogram"]
    got = ck.partition_histogram(dest, P)
    want = ck.partition_histogram_plain(dest, P)
    check(ck.LAUNCHES["partition_histogram"] - before ==
          (1 if dest.shape[0] else 0),
          f"partition_histogram {label}: launch count")
    err = float((got.long() - want.long()).abs().max())
    check(err == 0 and got.dtype == torch.int32 and got.shape == (P,),
          f"partition_histogram {label}: counts differ")
    print(f"partition_histogram {label}: n={dest.shape[0]} P={P} "
          f"counted={int(got.sum())} equal")
    return err


def partition_hist_cases(torch, n: int, P: int, gen, dev):
    """(label, dest) cases: uniform over [0, P), all one value, all out of
    range (P and -1), and Zipf(1.5)-skewed over [0, P)."""
    i32 = dict(dtype=torch.int32, device=dev)
    yield "uniform", torch.randint(0, P, (n,), generator=gen, **i32)
    yield "one value", torch.full((n,), P - 1, **i32)
    yield "all P", torch.full((n,), P, **i32)
    yield "all -1", torch.full((n,), -1, **i32)
    w = 1.0 / torch.arange(1, P + 1, dtype=torch.float64, device=dev) ** 1.5
    cdf = torch.cumsum(w / w.sum(), 0)
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    yield "zipf", torch.searchsorted(cdf, u).clamp(max=P - 1).to(torch.int32)


def check_partition_segments(torch, ck, dests, P: int, B: int,
                             label: str) -> None:
    """Both exchange kernels over S segments against their plain versions:
    the counts, the tile offsets and every row's slot; one launch each
    (none without rows)."""
    before = dict(ck.LAUNCHES)
    counts, tiles = ck.partition_histogram_segments(dests, P)
    got = ck.partition_positions(dests, P, B, tiles)
    rows = sum(d.shape[0] for d in dests)
    for kname in ("partition_histogram", "partition_positions"):
        check(ck.LAUNCHES[kname] - before[kname] == (1 if rows else 0),
              f"{kname} {label}: launch count")
    want_counts, want_tiles = ck.partition_histogram_segments_plain(dests, P)
    check(torch.equal(counts, want_counts) and torch.equal(tiles, want_tiles),
          f"partition_histogram {label}: counts or tile offsets differ")
    want = ck.partition_positions_plain(dests, P, B)
    check(all(a.dtype == torch.int64 and torch.equal(a, b)
              for a, b in zip(got, want)),
          f"partition_positions {label}: slots differ")
    print(f"partition_histogram + partition_positions {label}: "
          f"{len(dests)} segments, {rows} rows, P={P} B={B} equal")


def bucket_sorts(torch, shuffle, fn):
    """Run fn counting the ``torch.sort`` calls made inside the exchange's
    ``_bucket_rows``. Returns (fn's result, that count)."""
    inner_bucket, inner_sort = shuffle._bucket_rows, torch.sort
    depth, n = [0], [0]

    def bucket(*a, **kw):
        depth[0] += 1
        try:
            return inner_bucket(*a, **kw)
        finally:
            depth[0] -= 1

    def sort(*a, **kw):
        n[0] += depth[0] > 0
        return inner_sort(*a, **kw)
    shuffle._bucket_rows, torch.sort = bucket, sort
    try:
        return fn(), n[0]
    finally:
        shuffle._bucket_rows, torch.sort = inner_bucket, inner_sort


def layer_ms(torch, mod, name, fn) -> float:
    """Run fn with ``mod.name`` bracketed by CUDA events on the current
    stream; the summed device ms between them over every call."""
    inner = getattr(mod, name)
    spans = []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            return inner(*a, **kw)
        finally:
            end.record()
            spans.append((start, end))
    setattr(mod, name, timed)
    try:
        fn()
    finally:
        setattr(mod, name, inner)
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans)


def measure_tile_compact(torch, ck, sel, label: str) -> dict:
    """tile_compact_local at the arguments a path gave it: compared with
    its plain version, then timed beside it, torch.nonzero (which gives the
    END result of both kernels) and the bound."""
    cap = sel.shape[0]
    m = {
        "max_abs_err": check_tile_compact(torch, ck, sel, label),
        "ms": cuda_ms(torch, lambda: ck.tile_compact_local(sel), 10),
        "plain_ms": cuda_ms(
            torch, lambda: ck.tile_compact_local_plain(sel), 3),
        # selection read once, loc and counts written once
        "bound_ms": bound_ms(cap + 4 * cap + 4 * (cap // ck.TILE_ROWS)),
        "library_ms": cuda_ms(torch, lambda: torch.nonzero(sel), 3)}
    print(f"tile_compact_local {label}: {m['ms']:.3f} ms, bound "
          f"{m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms, "
          f"torch.nonzero {m['library_ms']:.3f} ms")
    return m


def measure_tile_stitch(torch, ck, loc, counts, starts, out_cap: int,
                        label: str) -> dict:
    """tile_stitch at the arguments a path gave it: compared with its plain
    version over all ``out_cap`` slots, then timed beside it and the
    bound."""
    got = ck.tile_stitch(loc, counts, starts, out_cap)
    err = float((got - ck.tile_stitch_plain(loc, counts, starts,
                                            out_cap)).abs().max())
    check(err == 0 and got.dtype == torch.int32 and
          got.shape == (out_cap,), f"tile_stitch {label}: indices differ")
    del got
    m = {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: ck.tile_stitch(loc, counts, starts,
                                                    out_cap), 10),
        "plain_ms": cuda_ms(torch, lambda: ck.tile_stitch_plain(
            loc, counts, starts, out_cap), 3),
        # the live slots of loc, counts and starts read once; every index
        # written once
        "bound_ms": bound_ms(4 * int(starts[-1]) + 4 * counts.shape[0] +
                             4 * starts.shape[0] + 4 * out_cap),
        "library_ms": None}
    print(f"tile_stitch {label}: cap={loc.shape[0]} out_cap={out_cap} "
          f"selected={int(starts[-1])} equal; {m['ms']:.3f} ms, bound "
          f"{m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms")
    return m


def dg_compare(torch, ck, gid, inputs, kinds, G, label: str,
               valid=None) -> float:
    """Kernel vs plain version slot for slot: integers and f32 min/max
    exact (NaN equal to NaN), f32 sums within the stated tolerance.
    Returns the max abs error over the f32 sums (0 elsewhere)."""
    rows, outs = ck.dense_group_reduce(gid, inputs, kinds, G, valid=valid)
    prows, pouts = ck.dense_group_reduce_plain(gid, inputs, kinds, G, valid)
    check(torch.equal(rows, prows), f"dense_group_reduce {label}: rows")
    if isinstance(gid, ck.DenseKey):
        gid = ck.dense_key_gid(gid, G)
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()
    err = 0.0
    oi = ij = 0
    for k, kind in enumerate(kinds):
        ni, no = ck._DG_ARITY[kind]
        for j in range(no):
            a, b = outs[oi + j], pouts[oi + j]
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"dense_group_reduce {label}: {kind} output type")
            if kind == "sum":
                at = slot if valid is None or valid[k] is None else \
                    torch.where(valid[k], slot, G)
                absum = torch.zeros(G + 1, dtype=torch.float64,
                                    device=gid.device).index_add_(
                    0, at, inputs[ij].double().abs())[:G]
                finite = ~absum.isnan()         # a NaN slot: NaN in both
                check(torch.equal(a.isnan(), b.isnan()),
                      f"dense_group_reduce {label}: sum NaN slots")
                d = (a.double() - b.double()).abs()[finite & ~a.isnan()]
                if d.numel():
                    err = max(err, float(d.max()))
                check(bool((d <= (SUM_RTOL * absum + SUM_ATOL_KERNEL)[
                    finite & ~a.isnan()]).all()),
                      f"dense_group_reduce {label}: sum out of tolerance")
            else:
                same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                    if a.is_floating_point() else a == b
                check(bool(same.all()),
                      f"dense_group_reduce {label}: {kind} output {j}")
        oi += no
        ij += ni
    print(f"dense_group_reduce {label}: n={gid.shape[0]} G={G} "
          f"kinds={len(kinds)} equal (sum max |diff| {err:.3g})")
    return err


def synthetic_dg_inputs(torch, n: int, G: int, gen, dev):
    """Every kind of the TPU contract once; gid in [-1, G + 8): inactive
    rows, rows past G, and one slot whose f32 inputs hold a NaN."""
    gid = torch.randint(-1, G + 8, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    kinds, inputs = [], []
    i32 = dict(dtype=torch.int32, device=dev, generator=gen)
    for kind in ("sum", "min", "max", "imin", "imax", "count", "sumc",
                 "imin64", "imax64"):
        kinds.append(kind)
        if kind in ("sum", "min", "max"):
            x = torch.randn(n, generator=gen, device=dev)
            if kind != "sum":
                x[gid == 3] = float("nan")
            inputs.append(x)
        elif kind == "sumc":
            inputs.append(torch.randint(0, 1 << 16, (n,), **i32))
        elif kind in ("imin64", "imax64"):
            inputs += [torch.randint(-(1 << 31), (1 << 31) - 1, (n,), **i32)
                       for _ in range(2)]
        else:
            inputs.append(torch.randint(-1000, 1000, (n,), **i32))
    return gid, tuple(inputs), tuple(kinds)


def synthetic_native_dg_inputs(torch, n: int, G: int, gen, dev, gid=None):
    """The card's native kinds over shared streams: first_row; sum, min and
    max of one f32 column (NaNs in slot 3); sum64, min64 and max64 of one
    int64 column (the type's extremes, sums that wrap); a count. ``gid`` as
    in ``synthetic_dg_inputs`` unless given. Returns (gid, inputs, kinds,
    valid): each column with its own validity stream."""
    if gid is None:
        gid = torch.randint(-1, G + 8, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    v = torch.randn(n, generator=gen, device=dev)
    v[gid == 3] = float("nan")
    w = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen, device=dev,
                      dtype=torch.int64)
    w[:n // 3] = torch.randint(-100, 100, (n // 3,), generator=gen,
                               device=dev, dtype=torch.int64)
    w[gid == 5] = (1 << 63) - 1 - torch.randint(
        0, 1000, (int((gid == 5).sum()),), generator=gen, device=dev,
        dtype=torch.int64)
    w[-1] = -(1 << 63)
    v_ok = torch.rand(n, generator=gen, device=dev) < 0.8
    w_ok = torch.rand(n, generator=gen, device=dev) < 0.8
    kinds = ("first_row", "sum", "min", "max", "sum64", "min64", "max64",
             "count")
    inputs = (v, v, v, w, w, w, w_ok.to(torch.int32))
    valid = (None, v_ok, v_ok, v_ok, w_ok, w_ok, w_ok, None)
    return gid, inputs, kinds, valid


def dg_bounds(torch, ck, gid, inputs, G, n_out_bytes: int, valid=None):
    """(bound_ms over the bytes this call's data needs, bound_ms with every
    stream read at every row): the gid read once, or of a ``DenseKey`` the
    key (and its validity) up to the length; each distinct input and
    validity stream read once at the active rows (slot in [0, G): the
    kernel needs no other row of them), or at every row; the outputs
    written once."""
    if isinstance(gid, ck.DenseKey):
        n = gid.values.shape[0]
        key_row = 8 + (0 if gid.validity is None else 1)
        slot_bytes, slot_bytes_all = key_row * int(gid.length), key_row * n
        gid = ck.dense_key_gid(gid, G)
    else:
        n = gid.shape[0]
        slot_bytes = slot_bytes_all = 4 * n
    streams = {x.data_ptr(): x.element_size() for x in inputs}
    streams.update({v.data_ptr(): 1 for v in valid or () if v is not None})
    per_row = sum(streams.values())
    active = int(((gid >= 0) & (gid < G)).sum())
    return (bound_ms(slot_bytes + active * per_row + n_out_bytes),
            bound_ms(slot_bytes_all + n * per_row + n_out_bytes))


def nine_kind_call(torch, gid, v, w):
    """The twelve 4-byte streams the earlier slices' ``consume_dense`` fed
    the kernel for path 1's query (the TPU caller's form): first row as an
    identity-masked iota under "imin", the valid counts of v and w, sum and
    min of v pre-masked, the int64 sum of w as four 16-bit limb streams of
    the sign-biased value, its int64 min as a (hi, biased lo) pair."""
    n = gid.shape[0]
    ok = gid >= 0
    i32max = (1 << 31) - 1
    iota = torch.arange(n, dtype=torch.int32, device=gid.device)
    u = w ^ (-(1 << 63))
    limbs = [torch.where(ok, (u >> (16 * k)) & 0xFFFF, 0).to(torch.int32)
             for k in range(4)]
    hi = torch.where(ok, (w >> 32).to(torch.int32), i32max)
    lo_b = torch.where(ok, ((w & 0xFFFFFFFF) - (1 << 31)).to(torch.int32),
                       i32max)
    count = ok.to(torch.int32)
    inputs = (torch.where(ok, iota, i32max), count, torch.where(ok, v, 0.0),
              torch.where(ok, v, float("inf")), count.clone(), *limbs, hi,
              lo_b)
    kinds = ("imin", "count", "sum", "min", "count", "sumc", "sumc", "sumc",
             "sumc", "imin64")
    return inputs, kinds


def check_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                     label: str, quiet: bool = False) -> float:
    """pack_key_lanes against its plain version: equal word for word.
    Returns the max abs difference."""
    got = ck.pack_key_lanes(lanes, lo, span, shift, active)
    want = ck.pack_key_lanes_plain(lanes, lo, span, shift, active)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    check(err == 0 and got.dtype == torch.int64 and got.shape == want.shape,
          f"pack_key_lanes {label}: packed keys differ")
    if not quiet:
        print(f"pack_key_lanes {label}: n={got.shape[0]} L={len(lanes)} "
              f"missed={int((got == ck.PACK_MISS).sum())} equal")
    return err


def measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                       label: str) -> dict:
    """pack_key_lanes at the arguments a path gave it: compared with its
    plain version, then timed beside it and the bound (every lane, and the
    active flags where given, read once; the keys written once)."""
    n = lanes[0].shape[0]

    def call(fn):
        return lambda: fn(lanes, lo, span, shift, active)
    m = {"max_abs_err": check_pack_lanes(torch, ck, lanes, lo, span, shift,
                                         active, label),
         "ms": cuda_ms(torch, call(ck.pack_key_lanes), 10),
         "plain_ms": cuda_ms(torch, call(ck.pack_key_lanes_plain), 3),
         "bound_ms": bound_ms(n * (8 * len(lanes) +
                                   (active is not None) + 8)),
         "library_ms": None}
    print(f"pack_key_lanes {label}: n={n} L={len(lanes)} {m['ms']:.3f} ms, "
          f"bound {m['bound_ms']:.3f} ms, plain {m['plain_ms']:.3f} ms")
    return m


def kernel_launches(ck, kname: str, args) -> int:
    """The launches one call of a kernel's wrapper makes with ``args``:
    none for no rows; B1 one for each ``FC_MAX_COLUMNS`` columns; the
    exchange's kernels one for all their segments."""
    if kname == "filter_compact_chunks":
        sel, columns = args
        return max(1, -(-len(columns) // ck.FC_MAX_COLUMNS)) \
            if sel.shape[0] else 0
    if kname in ("partition_histogram", "partition_positions"):
        return 1 if sum(d.shape[0] for d in args[0]) else 0
    return 1 if args[0][0].shape[0] else 0


def numpy_oracle(cols, num_keys: int = NUM_KEYS):
    """Group-by of the slice computed independently with numpy: per key
    (first-appearance order) count, sums (float64 bincount), mins (sort)."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    keys, first = np.unique(k, return_index=True)
    keys = keys[np.argsort(first, kind="stable")]
    cnt = np.bincount(k, minlength=num_keys)
    v_sum = np.bincount(k, weights=v.astype(np.float64), minlength=num_keys)
    v_abs = np.bincount(k, weights=np.abs(v).astype(np.float64),
                        minlength=num_keys)
    w_sum = np.bincount(k, weights=w.astype(np.float64), minlength=num_keys)
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    v_min = np.full(num_keys, np.inf, np.float32)
    w_min = np.zeros(num_keys, np.int64)
    v_min[ks[starts]] = np.minimum.reduceat(v[order], starts)
    w_min[ks[starts]] = np.minimum.reduceat(w[order], starts)
    return dict(keys=keys, count=cnt, v_sum=v_sum, v_abs=v_abs,
                w_sum=np.rint(w_sum).astype(np.int64), v_min=v_min,
                w_min=w_min)


def check_slice(out, oracle) -> int:
    n = len(out)
    col = {name: out.column(name).values[:n].cpu().numpy()
           for name in out.column_names}
    keys = col["k"]
    check(np.array_equal(keys, oracle["keys"]),
          "slice: keys or their first-appearance order")
    check(np.array_equal(col["count_all"], oracle["count"][keys]),
          "slice: count_all")
    check(np.array_equal(col["w_sum"], oracle["w_sum"][keys]), "slice: w_sum")
    check(np.array_equal(col["w_min"], oracle["w_min"][keys]), "slice: w_min")
    check(np.array_equal(col["v_min"], oracle["v_min"][keys]), "slice: v_min")
    d = np.abs(col["v_sum"].astype(np.float64) - oracle["v_sum"][keys])
    check(bool((d <= SUM_RTOL * oracle["v_abs"][keys] + SUM_ATOL_SLICE)
               .all()), f"slice: v_sum off by up to {d.max():.3g}")
    for name in out.column_names:
        validity = out.column(name).validity
        check(validity is None or bool(validity[:n].all()),
              f"slice: nulls in {name}")
    return n


def numpy_oracle_generic(cols, num_keys: int):
    """Path 2's group-by computed independently with numpy: one stable sort
    of the selected keys gives the present keys, their first rows and the
    run starts for the mins; bincount gives counts and float64 sums."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    present = ks[starts]
    keys = present[np.argsort(order[starts], kind="stable")]
    w_min = np.zeros(num_keys, np.int64)
    w_min[present] = np.minimum.reduceat(w[order], starts)
    return dict(keys=keys, count=np.bincount(k, minlength=num_keys),
                v_sum=np.bincount(k, weights=v, minlength=num_keys),
                v_abs=np.bincount(k, weights=np.abs(v), minlength=num_keys),
                w_min=w_min)


def check_slice_generic(out, oracle) -> int:
    n = len(out)
    col = {name: out.column(name).values[:n].cpu().numpy()
           for name in out.column_names}
    keys = col["k"]
    check(np.array_equal(keys, oracle["keys"]),
          "path 2: keys or their first-appearance order")
    check(np.array_equal(col["count_all"], oracle["count"][keys]),
          "path 2: count_all")
    check(np.array_equal(col["w_min"], oracle["w_min"][keys]),
          "path 2: w_min")
    d = np.abs(col["v_sum"] - oracle["v_sum"][keys])
    check(bool((d <= SUM64_RTOL * oracle["v_abs"][keys] + SUM64_ATOL).all()),
          f"path 2: v_sum off by up to {d.max():.3g}")
    for name in out.column_names:
        validity = out.column(name).validity
        check(validity is None or bool(validity[:n].all()),
              f"path 2: nulls in {name}")
    return n


def check_dist_group_by(np_, table, oracle, n_shards: int, shard_of) -> int:
    """Path 3a's Table against the numpy oracle: the groups as a set, every
    key once (so on exactly one shard) and on the shard its hash names,
    integers exact, f64 sums within tolerance."""
    check(len(table.batches) == n_shards, "path 3a: a shard has no groups")
    col = {name: [] for name in table.column_names}
    for s, b in enumerate(table.batches):
        n = len(b)
        for name in table.column_names:
            a = b.column(name)
            check(a.validity is None or bool(a.validity[:n].all()),
                  f"path 3a: nulls in {name}")
            col[name].append(a.values[:n].cpu().numpy())
        check(bool((shard_of(b.column("k"))[:n] == s).all()),
              f"path 3a: a group of shard {s} hashes elsewhere")
    col = {name: np_.concatenate(v) for name, v in col.items()}
    keys = col["k"]
    check(np_.unique(keys).shape[0] == keys.shape[0],
          "path 3a: a group lies on more than one shard")
    check(np_.array_equal(np_.sort(keys), np_.sort(oracle["keys"])),
          "path 3a: the set of groups")
    check(np_.array_equal(col["count_all"], oracle["count"][keys]),
          "path 3a: count_all")
    check(np_.array_equal(col["w_min"], oracle["w_min"][keys]),
          "path 3a: w_min")
    d = np_.abs(col["v_sum"] - oracle["v_sum"][keys])
    check(bool((d <= SUM64_RTOL * oracle["v_abs"][keys] + SUM64_ATOL).all()),
          f"path 3a: v_sum off by up to {d.max():.3g}")
    return keys.shape[0]


def numpy_sort_oracle(cols):
    """Path 4's stable sort permutation computed independently with numpy:
    ONE composite uint64 key per row (k1 in the top bits, then the null
    flag of k2, then k2 descending: its sign-biased bits inverted, 0 where
    null), sorted with numpy's stable sort."""
    k2 = (cols["k2"].astype(np.int64) + (1 << 31)).astype(np.uint64)
    desc = np.where(cols["k2_valid"], np.uint64(0xFFFFFFFF) - k2,
                    np.uint64(0))
    key = (cols["k1"].astype(np.uint64) << np.uint64(33)) | \
        ((~cols["k2_valid"]).astype(np.uint64) << np.uint64(32)) | desc
    return np.argsort(key, kind="stable")


def numpy_join_oracle(bcols, pcols, join_type: str):
    """The join's rows computed independently with numpy, as columns (k,
    k_valid, lv, lv_valid, rv, rv_valid): the build side sorted by key, a
    per-key (start, count) lookup table, every probe row expanded by its
    count (``np.repeat``). ``join_type``: inner, left outer, full outer,
    left semi or left anti (no rv column for the last two)."""
    bk, pk = bcols["k"], pcols["k"]
    nk = int(max(bk.max(), pk.max())) + 1
    order = np.argsort(bk, kind="stable")
    count = np.bincount(bk, minlength=nk)
    start = np.cumsum(count) - count
    c = count[pk]
    if join_type in ("left semi", "left anti"):
        keep = (c > 0) if join_type == "left semi" else (c == 0)
        n = int(keep.sum())
        ones = np.ones(n, bool)
        return dict(k=pk[keep], k_valid=ones, lv=pcols["lv"][keep],
                    lv_valid=ones, rv=None, rv_valid=None)
    emit = c if join_type == "inner" else np.maximum(c, 1)
    r = np.repeat(np.arange(pk.shape[0]), emit)
    first = np.cumsum(emit) - emit
    o = np.arange(r.shape[0]) - first[r]
    matched = o < c[r]
    brow = order[np.where(matched, start[pk[r]] + o, 0)]
    k, lv, rv = pk[r], pcols["lv"][r], bcols["rv"][brow]
    k_valid = lv_valid = np.ones(r.shape[0], bool)
    if join_type == "full outer":
        un = np.bincount(pk, minlength=nk)[bk] == 0     # unmatched build rows
        t = int(un.sum())
        k = np.concatenate([k, np.zeros(t, k.dtype)])
        lv = np.concatenate([lv, np.zeros(t, lv.dtype)])
        rv = np.concatenate([rv, bcols["rv"][un]])
        k_valid = lv_valid = np.concatenate([k_valid, np.zeros(t, bool)])
        matched = np.concatenate([matched, np.ones(t, bool)])
    return dict(k=k, k_valid=k_valid, lv=lv, lv_valid=lv_valid, rv=rv,
                rv_valid=matched)


def canonical_rows(torch, k, k_valid, lv, lv_valid, rv, rv_valid):
    """Join rows on the card in one canonical order, as int64 columns (key,
    lv bits, rv bits; a null as the smallest value): sorted by all three,
    so that two row multisets are equal iff the results are."""
    low = -(1 << 63)
    cols = [torch.where(k_valid, k, low) if k_valid is not None else k,
            lv.view(torch.int32).to(torch.int64)]
    if lv_valid is not None:
        cols[1] = torch.where(lv_valid, cols[1], low)
    if rv is not None:
        bits = rv.view(torch.int64)
        cols.append(bits if rv_valid is None
                    else torch.where(rv_valid, bits, low))
    perm = torch.argsort(cols[-1], stable=True)
    for c in cols[-2::-1]:
        perm = perm[torch.argsort(c[perm], stable=True)]
    return [c[perm] for c in cols]


def check_join(torch, dev, label: str, outs, oracle, wide_mul=None) -> int:
    """The join's output batches (probe output, finish output) against the
    numpy oracle's rows, as multisets. Returns the row count."""
    parts = {n: [] for n in ("k", "k_valid", "lv", "lv_valid", "rv",
                             "rv_valid")}
    has_rv = oracle["rv"] is not None
    for b in outs:
        if b is None:
            continue
        n = len(b)
        names = ["k", "lv"] + (["rv"] if has_rv else [])
        for name in names:
            a = b.column(name)
            parts[name].append(a.values[:n])
            parts[name + "_valid"].append(
                torch.ones(n, dtype=torch.bool, device=dev)
                if a.validity is None else a.validity[:n])
        if wide_mul is not None:        # the second key follows the first
            k2 = b.column("k2")
            check(bool((k2.values[:n] == b.column("k").values[:n] * wide_mul)
                       .all()), f"{label}: k2 does not follow k")
    got = {n: (torch.cat(v) if v else None) for n, v in parts.items()}
    n_rows = got["k"].shape[0]
    check(n_rows == oracle["k"].shape[0],
          f"{label}: {n_rows} rows, the oracle has {oracle['k'].shape[0]}")
    want = {n: (None if v is None else torch.from_numpy(v).to(dev))
            for n, v in oracle.items()}
    a = canonical_rows(torch, *[got[n] for n in parts])
    del got
    b = canonical_rows(torch, *[want[n] for n in parts])
    del want
    for x, y, name in zip(a, b, ("k", "lv", "rv")):
        check(torch.equal(x, y), f"{label}: column {name} of the sorted rows")
    return n_rows


def numpy_q3_oracle(li, od, cu):
    """Path 6's plan computed independently with numpy: the filters as
    masks; the joins as lookups (``o_orderkey`` and ``c_custkey`` are
    aranges, so a key is its row); ``rev`` in float64 as the engine types
    ``l_price * (1.0 - l_disc)``, summed per order by ``np.bincount``
    (``o_date`` is a function of the order); the top 10 by (revenue
    descending, l_orderkey ascending). Returns the top rows and every
    order's revenue (NaN for an order with no row) and date."""
    ok_o = (od["o_date"] < 25) & (cu["c_seg"][od["o_custkey"]] == 1)
    m = (li["l_ship"] > 40) & ok_o[li["l_orderkey"]]
    k = li["l_orderkey"][m]
    rev = li["l_price"][m].astype(np.float64) * \
        (1.0 - li["l_disc"][m].astype(np.float64))
    no = od["o_orderkey"].shape[0]
    revenue = np.bincount(k, weights=rev, minlength=no)
    present = np.bincount(k, minlength=no) > 0
    keys = np.flatnonzero(present)
    top = keys[np.lexsort((keys, -revenue[keys]))[:10]]
    return dict(keys=top, revenue=revenue[top], all_o_date=od["o_date"],
                all_revenue=np.where(present, revenue, np.nan),
                n_groups=keys.shape[0])


def check_q3(table, oracle, label: str = "path 6") -> int:
    """Path 6's (or 7b's) Table against the numpy oracle: 10 rows; o_date
    exact; revenue within 1e-12 * revenue + 1e-12 of the oracle's at each place
    (a sum of positive terms: its sum of |rev| is itself); keys exact but
    where a key's oracle revenue lies within that tolerance of the oracle's
    revenue at the place (a tie the summation order may break either way).
    Returns the oracle's group count."""
    check(len(table.batches) == 1, f"{label}: one result batch")
    b = table.batches[0]
    n = len(b)
    got = {c: b.column(c).values[:n].cpu().numpy()
           for c in ("l_orderkey", "o_date", "revenue")}
    for c in got:
        a = b.column(c)
        check(a.validity is None or bool(a.validity[:n].all()),
              f"{label}: nulls in {c}")
    want = oracle["revenue"]
    tol = 1e-12 * want + 1e-12
    check(n == 10 and got["revenue"].dtype == np.float64,
          f"{label}: {n} rows of {got['revenue'].dtype}")
    check(bool((np.abs(got["revenue"] - want) <= tol).all()),
          f"{label}: revenue differs from the oracle's")
    k = got["l_orderkey"]
    tie = np.abs(oracle["all_revenue"][k] - want) <= tol
    check(bool(((k == oracle["keys"]) | tie).all()),
          f"{label}: keys {k.tolist()}, the oracle's "
          f"{oracle['keys'].tolist()}")
    check(np.array_equal(got["o_date"], oracle["all_o_date"][k]),
          f"{label}: o_date")
    return oracle["n_groups"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from arrow_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: arrow_tpu_torch not importable ({e}); run "
              "from the repository root", file=sys.stderr)
        return 2
    from arrow_tpu_torch.entry import example_columns, \
        example_columns_generic
    import arrow_tpu_torch.entry as entry_mod
    from arrow_tpu_torch.core import datatype
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.ops import hash_aggregate, selection

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    path, log = ck.build()
    print(f"build: {time.time() - t0:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---- B1 against its plain version ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sel_cases(cap):
        yield "half", torch.rand(cap, generator=gen, device=dev) < 0.5
        yield "none", torch.zeros(cap, dtype=torch.bool, device=dev)
        yield "all", torch.ones(cap, dtype=torch.bool, device=dev)

    def column(cap, dtype):
        """(cap,) random bits of a dtype (bool as 0 / 1)."""
        raw = torch.randint(-(1 << 62), 1 << 62, (cap,), generator=gen,
                            device=dev, dtype=torch.int64)
        if dtype == torch.bool:
            return raw > 0
        size = torch.empty((), dtype=dtype).element_size()
        return raw.view(torch.uint8).view(cap, 8)[:, :size].contiguous() \
            .view(dtype).reshape(cap)

    # the one-matrix form, the TPU function's contract
    for cap in (1000, 256 * 4096):
        chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                               dtype=torch.uint8)
        for name, sel in sel_cases(cap):
            check_filter_chunks(torch, ck, sel, chunks, name)
    # the column form: every width in one launch, caps that end mid tile
    fc_dtypes = (torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.float16, torch.int32, torch.uint32, torch.float32,
                 torch.int64, torch.uint64, torch.float64, torch.bool)
    for cap in (1, 4097, (1 << 20) + 3):
        cols = [column(cap, t) for t in fc_dtypes] + [torch.randint(
            0, 256, (cap, 20), generator=gen, device=dev,
            dtype=torch.uint8)]
        for name, sel in sel_cases(cap):
            before = ck.LAUNCHES["filter_compact_chunks"]
            check_filter(torch, ck, sel, cols, f"every width, {name}")
            check(ck.LAUNCHES["filter_compact_chunks"] == before + 1,
                  "filter_compact_columns: one launch for 13 columns")
    # views off the 16-byte grid and strided; more columns than a launch
    cap = (1 << 20) + 3
    base = torch.rand(cap + 16, generator=gen, device=dev) < 0.5
    mat = torch.randint(0, 256, (cap, 24), generator=gen, device=dev,
                        dtype=torch.uint8)
    wide = column(3 * cap + 16, torch.int64)
    check_filter(torch, ck, base[3:3 + cap],
                 [wide[3:3 + cap], wide[::3][:cap].view(torch.float64),
                  column(2 * cap, torch.int32)[1::2], mat[:, 3:11],
                  mat[:, 5], base[5:5 + cap]], "views")
    before = ck.LAUNCHES["filter_compact_chunks"]
    check_filter(torch, ck, base[:cap],
                 [column(cap, fc_dtypes[i % 12]) for i in range(70)],
                 "70 columns")
    check(ck.LAUNCHES["filter_compact_chunks"] == before + 3,
          "filter_compact_columns: 70 columns in 3 launches")
    del cols, base, mat, wide
    # the one-matrix form at 100M x 20 B
    cap = N_ROWS
    chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                           dtype=torch.uint8)
    for name, sel in sel_cases(cap):
        check_filter_chunks(torch, ck, sel, chunks, name)
        if name == "half":
            fc_matrix = measure_filter(torch, ck, sel, [chunks],
                                       "one matrix 100M x 20 B, half")
    del chunks, sel
    torch.cuda.empty_cache()

    # ---- tile_compact_local and tile_stitch against their plain versions
    padded = N_ROWS + (-N_ROWS) % ck.TILE_ROWS
    for cap in (1024, 1 << 20, padded):
        for name, sel in selection_cases(torch, cap, gen, dev):
            check_tile_compact(torch, ck, sel, name)
            check_tile_stitch(torch, ck, sel, cap, name)
        # a view that starts off the 16-byte grid is read as it is
        base = torch.rand(cap + 16, generator=gen, device=dev) < 0.5
        for off in (1, 4, 9):
            view = base[off:off + cap]
            check(view.data_ptr() % 16 != 0, "the view is aligned")
            check_tile_compact(torch, ck, view, f"view at byte {off}")
    # tiles with 0, 1, 1023 and 1024 selected rows; bytes other than 0 / 1
    sel = torch.zeros(4096, dtype=torch.bool, device=dev)
    sel[1024 + 5] = True
    sel[2048:3071] = True
    sel[3072:] = True
    check_tile_compact(torch, ck, sel, "0 / 1 / 1023 / 1024 a tile")
    check(ck.tile_compact_local(sel)[1].tolist() == [0, 1, 1023, 1024],
          "tile_compact_local: counts of the edge tiles")
    check_tile_stitch(torch, ck, sel, 4096, "0 / 1 / 1023 / 1024 a tile")
    check_tile_stitch(torch, ck, sel, 2048 + 3, "out_cap = the count + 3")
    raw = torch.randint(0, 256, (1 << 20,), generator=gen, device=dev,
                        dtype=torch.uint8)
    raw[torch.rand(1 << 20, generator=gen, device=dev) < 0.5] = 0
    loc, counts = ck.tile_compact_local(raw.view(torch.bool))
    ploc, pcounts = ck.tile_compact_local_plain(raw != 0)
    check(torch.equal(loc, ploc) and torch.equal(counts, pcounts),
          "tile_compact_local: a nonzero byte other than 1 is selected")
    del raw, loc, counts, ploc, pcounts, base, view
    for cap in (1000, N_ROWS):
        sel = torch.rand(cap, generator=gen, device=dev) < 0.5
        check_take_indices(torch, selection, Array, datatype.bool_, sel,
                           "half")
    del sel
    torch.cuda.empty_cache()

    # ---- dense_group_reduce against its plain version ------------------
    for G in (128, 1024, 4096):
        n = (1 << 20) + 3               # a last step of 3 rows
        gid, inputs, kinds = synthetic_dg_inputs(torch, n, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"TPU kinds G={G}")
        gid, inputs, kinds, valid = synthetic_native_dg_inputs(
            torch, n, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"native kinds G={G}",
                   valid)
        dg_compare(torch, ck, gid, inputs, kinds, G,
                   f"native kinds, no validity, G={G}")
        dg_compare(torch, ck, gid[1:], tuple(x[1:] for x in inputs), kinds,
                   G, f"native kinds, views off the 16-byte grid, G={G}",
                   tuple(x if x is None else x[1:] for x in valid))
        # the slots formed in the kernel from a key column: null keys,
        # keys outside the domain, rows past a length on the device
        lo = -(1 << 40)
        key = ck.DenseKey(gid.long() + lo, lo,
                          torch.tensor(n - n // 5, device=dev),
                          torch.rand(n, generator=gen, device=dev) < 0.9)
        check(int((ck.dense_key_gid(key, G) == G - 1).sum()) > n // 20,
              "dense_key_gid: the null-key slot")
        dg_compare(torch, ck, key, inputs, kinds, G,
                   f"native kinds, slots from the key column, G={G}", valid)
        dg_compare(torch, ck, ck.DenseKey(key.values[1:], lo, n // 2, None),
                   tuple(x[1:] for x in inputs), kinds, G,
                   f"native kinds, key view off the 16-byte grid, G={G}")
        # skew: every row in one slot; 60 % of the rows in one slot
        one = torch.full((n,), G - 1, dtype=torch.int32, device=dev)
        hot = torch.where(torch.rand(n, generator=gen, device=dev) < 0.6,
                          5, gid)
        for name, g in (("every row in one slot", one), ("60 % in one slot",
                                                         hot)):
            _, inputs, kinds, valid = synthetic_native_dg_inputs(
                torch, n, G, gen, dev, g)
            dg_compare(torch, ck, g, inputs, kinds, G,
                       f"native kinds, {name}, G={G}", valid)
    del gid, inputs, valid, one, hot, g, key

    # ---- partition_histogram against its plain version -----------------
    for n in (0, 1, 1000, 1 << 20, N_ROWS):
        for P in (1, 8, 128):
            for name, dest in partition_hist_cases(torch, n, P, gen, dev):
                check_partition_hist(torch, ck, dest, P, name)
    del dest
    # ... and both exchange kernels over segments of unequal lengths (every
    # other one a view off a 16-byte boundary), buckets that hold all, some
    # and none of the rows
    sizes = [0, 1, 8191, 8193, 1 << 19, (1 << 20) + 5, 3_125_000, 0]
    for P in (1, 8, 128):
        cases = {}
        for n in sizes:
            for name, dest in partition_hist_cases(torch, n + 1, P, gen, dev):
                cases.setdefault(name, []).append(
                    dest[1:] if len(cases.get(name, [])) % 2 else dest[:n])
        for name, dests in cases.items():
            for B in (max(sizes), 3_125_000 // (2 * P), 0):
                check_partition_segments(torch, ck, dests, P, B,
                                         f"{name}, 8 segments")
            check_partition_segments(torch, ck, dests[5:6], P, 1000,
                                     f"{name}, 1 segment")
    del cases, dests

    # ---- pack_key_lanes against its plain version ----------------------
    for n in (1, 1000, 1 << 20, N_ROWS):
        for L in (1, 3, 6):
            per = 30 // L
            lo = torch.randint(0, 1 << 32, (L,), generator=gen, device=dev)
            lo[0] = (1 << 32) - 3       # a window across the 2^32 wrap
            span = torch.full((L,), (1 << per) - 1, device=dev)
            shift = torch.arange(L - 1, -1, -1, device=dev) * per
            cols_ = [(int(lo[j]) + torch.randint(
                0, (1 << per) + 2, (n,), generator=gen, device=dev))
                % (1 << 32) for j in range(L)]
            active = torch.rand(n, generator=gen, device=dev) < 0.9
            check_pack_lanes(torch, ck, cols_, lo, span, shift, active,
                             "lanes of their own")
            if n <= 1 << 20:
                mat = torch.stack(cols_, dim=1)
                check_pack_lanes(torch, ck, mat.unbind(1), lo, span,
                                 shift + 9, None, "matrix columns, the top "
                                 "lane shifted out")
                del mat
            del cols_, active
    torch.cuda.empty_cache()

    # ---- path 1: arrow_tpu_torch.entry.entry ----------------------------
    paths = {}      # each path's counted run: step ms and peak bytes
    t0 = time.time()
    cols = example_columns(N_ROWS, NUM_KEYS, args.seed)
    step, (b,) = entry_mod.entry(dev, N_ROWS, NUM_KEYS, args.seed)
    torch.cuda.synchronize()
    print(f"path 1 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 1
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("filter_compact_chunks", "dense_group_reduce"):
        check(launches[name] > 0, f"{name} was not launched on path 1's run")
    n_groups = check_slice(out, numpy_oracle(cols))
    print(f"path 1: {N_ROWS} rows in {secs * 1e3:.3f} ms = "
          f"{N_ROWS / secs:.6g} rows/s; {n_groups} groups match the numpy "
          f"oracle; peak device memory {peak} B; launches {launches}")
    paths["path 1"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del out, cols

    # one more run, recording the arguments each kernel gets on the path
    seen, seen_calls = {}, {}

    def recorded(mod, name, fn):
        """Run fn with mod.name wrapped to record its arguments: the last
        call's in ``seen``, every call's in ``seen_calls``."""
        inner = getattr(mod, name)

        def rec(*a):
            seen[name] = a
            seen_calls.setdefault(name, []).append(a)
            return inner(*a)
        setattr(mod, name, rec)
        try:
            return fn()
        finally:
            setattr(mod, name, inner)

    def forget():
        seen.clear()
        seen_calls.clear()

    # the function in ``selection`` that launches each kernel, where its
    # name is not the kernel's
    wrapper = {"filter_compact_chunks": "filter_compact_columns"}

    recorded(selection, "filter_compact_columns", lambda: recorded(
        hash_aggregate, "dense_group_reduce", lambda: step(b)))
    # and one with the filter layer (expression excluded) between events
    paths["path 1"]["filter_layer_ms"] = layer_ms(
        torch, entry_mod, "filter_batch", lambda: step(b))
    print(f"path 1 filter layer: {paths['path 1']['filter_layer_ms']:.3f} "
          "ms")
    del b, step

    # ---- path 1's kernels at its shapes: error, times, bound ------------
    sel, columns = seen["filter_compact_columns"]
    check(fc_widths(columns) == [8, 4, 8],
          f"path 1 gave B1 columns of {fc_widths(columns)} bytes, not its "
          "k, v and w as they are")
    fc = measure_filter(torch, ck, sel, columns, "path 1 shape")
    del sel, columns
    gid, inputs, kinds, G, valid = seen["dense_group_reduce"]
    check(isinstance(gid, ck.DenseKey) and
          kinds == ("first_row", "sum", "min", "sum64", "min64") and
          all(x is None for x in valid) and
          inputs[0] is inputs[1] and inputs[2] is inputs[3],
          f"path 1 gave dense_group_reduce {kinds} over {len(inputs)} "
          "streams: not the key and the columns themselves, each once")

    def measure_dg(gid, inputs, kinds, label):
        out_bytes = 4 * G + sum(ck._dg_acc_bytes(k, G) for k in kinds)
        bound, bound_all = dg_bounds(torch, ck, gid, inputs, G, out_bytes)
        m = {"max_abs_err": dg_compare(torch, ck, gid, inputs, kinds, G,
                                       label),
             "ms": cuda_ms(torch, lambda: ck.dense_group_reduce(
                 gid, inputs, kinds, G), 10),
             "plain_ms": cuda_ms(torch, lambda: ck.dense_group_reduce_plain(
                 gid, inputs, kinds, G), 3),
             "bound_ms": bound, "bound_ms_all_rows": bound_all,
             "library_ms": None}
        print(f"dense_group_reduce {label}: {m['ms']:.3f} ms, bound "
              f"{m['bound_ms']:.3f} ms ({m['bound_ms_all_rows']:.3f} with "
              f"every stream read at every row), plain "
              f"{m['plain_ms']:.3f} ms")
        return m

    dg = measure_dg(gid, inputs, kinds, "path 1 shape")
    # the same query as the earlier slices asked it: a gid built by
    # elementwise passes and twelve 32-bit streams
    v, w = inputs[0], inputs[2]
    del inputs
    gid = ck.dense_key_gid(gid, G)
    inputs9, kinds9 = nine_kind_call(torch, gid, v, w)
    dg9 = measure_dg(gid, inputs9, kinds9, "path 1 shape, nine-kind call")
    del gid, v, w, inputs9
    forget()
    torch.cuda.empty_cache()

    # ---- path 2: arrow_tpu_torch.entry.entry_generic --------------------
    t0 = time.time()
    cols = example_columns_generic(N_ROWS, NUM_KEYS_GENERIC, args.seed)
    step, (b,) = entry_mod.entry_generic(dev, N_ROWS, NUM_KEYS_GENERIC,
                                         args.seed, MAX_GROUPS_GENERIC)
    torch.cuda.synchronize()
    print(f"path 2 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 2
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches2 = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("tile_compact_local", "tile_stitch"):
        check(launches2[name] > 0,
              f"{name} was not launched on path 2's run")
    n_groups = check_slice_generic(
        out, numpy_oracle_generic(cols, NUM_KEYS_GENERIC))
    del out, cols

    # one more run, recording the kernels' arguments and the route taken
    routes = []
    probe_route = hash_aggregate.HashAggregate.probe_route

    def route_rec(self, batch, vals):
        routes.append(probe_route(self, batch, vals))
        return routes[-1]
    hash_aggregate.HashAggregate.probe_route = route_rec
    try:
        recorded(selection, "tile_compact_local", lambda: recorded(
            selection, "tile_stitch", lambda: step(b)))
    finally:
        hash_aggregate.HashAggregate.probe_route = probe_route
    check(len(routes) == 1, "path 2: one probe per step")
    route = routes[0][0]
    check(route in ("packed", "generic"), f"path 2 took route {route!r}")
    print(f"path 2: {N_ROWS} rows in {secs * 1e3:.3f} ms = "
          f"{N_ROWS / secs:.6g} rows/s; route {route}; {n_groups} groups "
          f"match the numpy oracle; peak device memory {peak} B; launches "
          f"{launches2}")
    paths["path 2"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del b, step

    # ---- path 2's kernels at its shape: error, times, bound -------------
    (sel,) = seen["tile_compact_local"]
    tc = measure_tile_compact(torch, ck, sel, "path 2 shape")
    # torch.nonzero gives the END result (both kernels), so the whole of
    # get_take_indices is timed beside it too
    mask = Array(datatype.bool_, sel[:N_ROWS])
    ti_ms = cuda_ms(torch, lambda: selection.get_take_indices(mask), 3)
    print(f"get_take_indices path 2 shape: {ti_ms:.3f} ms")
    cap = sel.shape[0]
    del sel, mask
    loc, counts, starts, out_cap = seen["tile_stitch"]
    check(out_cap == N_ROWS and loc.shape[0] == cap,
          f"path 2 stitched {loc.shape[0]} slots into {out_cap}")
    ts = measure_tile_stitch(torch, ck, loc, counts, starts, out_cap,
                             "path 2 shape")
    del loc, counts, starts
    forget()
    torch.cuda.empty_cache()

    # ---- path 3a: arrow_tpu_torch.entry.entry_distributed ---------------
    from arrow_tpu_torch.ops.hashing import hash32
    from arrow_tpu_torch.parallel import dist_agg, shuffle
    t0 = time.time()
    cols = example_columns_generic(N_ROWS, NUM_KEYS_DIST, args.seed)
    step, (b,) = entry_mod.entry_distributed(
        dev, N_SHARDS, N_ROWS, NUM_KEYS_DIST, MAX_GROUPS_PER_SHARD,
        args.seed)
    torch.cuda.synchronize()
    print(f"path 3 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    # exchanged per state row: key (8 B + 1 B validity), sum (8 + 8),
    # min (8 + 8), count_all (8) = 49 B; per shard a send buffer, a
    # received buffer and its compaction of P * G rows each
    xrows = N_SHARDS * MAX_GROUPS_PER_SHARD
    print(f"path 3a reckoned: exchange buffers {N_SHARDS} shards x 3 x "
          f"{xrows} rows x 49 B = {N_SHARDS * 3 * xrows * 49} B, input "
          f"{N_ROWS * 24} B")

    step(b)                     # warm-up
    torch.cuda.synchronize()

    # the timed, counted run of path 3a
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    table = step(b)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches3 = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3[kname] == 1,
              f"path 3a launched {kname} {launches3[kname]} times, not once "
              "for its one exchange on one card")
    check(launches3["filter_compact_chunks"] == N_SHARDS,
          "path 3a: one pre-filter kernel pass per shard")

    def shard_of(seed, n_shards):
        return lambda key: hash32([key], seed=seed) % n_shards

    n_groups = check_dist_group_by(
        np, table, numpy_oracle_generic(cols, NUM_KEYS_DIST), N_SHARDS,
        shard_of(dist_agg._STATE_EXCHANGE_SEED, N_SHARDS))
    print(f"path 3a: {N_ROWS} rows over {N_SHARDS} logical shards in "
          f"{secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; {n_groups} "
          f"groups match the numpy oracle, each on the one shard its hash "
          f"names; peak device memory {peak} B; launches {launches3}")
    paths["path 3a"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del table

    # one more run, recording what the kernels get (the last shard's
    # filter, the exchange's one call over all shards); then the kernels at
    # those arguments: error, times, bound
    _, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
        selection, "filter_compact_columns", lambda: recorded(
            shuffle, "partition_histogram_segments", lambda: recorded(
                shuffle, "partition_positions", lambda: step(b)))))
    check(sorts == 0, f"path 3a: {sorts} torch.sort calls in _bucket_rows")
    del step
    sel, columns = seen["filter_compact_columns"]
    check(sel.shape[0] >= N_ROWS // N_SHARDS and
          sum(fc_widths(columns)) == 24,
          f"path 3a: a shard's filter columns are {fc_widths(columns)} "
          f"bytes over {sel.shape[0]} rows")
    fc3a = measure_filter(torch, ck, sel, columns, "path 3a shape")
    del sel, columns
    dests, P = seen["partition_histogram_segments"]
    check(len(dests) == N_SHARDS and P == N_SHARDS and
          all(d.shape[0] == MAX_GROUPS_PER_SHARD for d in dests),
          f"path 3a: the exchange counts {len(dests)} segments over {P}")
    _, _, B, _ = seen["partition_positions"]
    ph = measure_hist(torch, ck, dests, P, "path 3a shape")
    pp = measure_positions(torch, ck, dests, P, B, "path 3a shape")
    del dests
    forget()
    torch.cuda.empty_cache()

    # ---- path 3b: the raw-row exchange (shuffle_batch) ------------------
    from arrow_tpu_torch.parallel import DistContext
    ctx = DistContext(devices=[dev] * N_SHARDS_RAW)
    sharded = ctx.shard_batch(b)
    bucket = 2 * sharded.local_capacity
    print(f"path 3b: {N_SHARDS_RAW} logical shards (8 would need "
          f"{2 * 8 * 2 * N_ROWS * 24} B for send buffers and results "
          f"alone), bucket capacity {bucket}, reckoned send + received + "
          f"result buffers {3 * N_SHARDS_RAW * 2 * N_ROWS * 24} B")

    def raw_exchange():
        return shuffle.shuffle_batch(sharded.shards, ["k"], ctx.devices,
                                     bucket_capacity=bucket)

    out = raw_exchange()        # warm-up
    torch.cuda.synchronize()
    del out

    # the timed, counted run of path 3b
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    out = raw_exchange()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches3b = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(launches3b[kname] == 1,
              f"path 3b: {launches3b[kname]} {kname} launches, not one")
    check(not any(bool(err) for _, err in out), "path 3b: error flag set")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS_RAW)
    rows, k_sum, w_sum, v_sum = 0, 0, 0, 0.0
    for p, (rb, _) in enumerate(out):
        n = len(rb)
        rows += n
        k = rb.column("k")
        check(bool((place(k)[:n] == p).all()),
              f"path 3b: a row of shard {p} hashes elsewhere")
        k_sum += int(k.values[:n].sum())
        w_sum += int(rb.column("w").values[:n].sum())
        v_sum += float(rb.column("v").values[:n].sum())
        for name in rb.column_names:
            check(not bool(rb.column(name).values[n:].any()),
                  f"path 3b: {name} of shard {p} is not zero past its rows")
    check(rows == N_ROWS, f"path 3b: {rows} rows came out of {N_ROWS}")
    check(k_sum == int(cols["k"].sum()) and w_sum == int(cols["w"].sum()),
          "path 3b: integer column sums changed")
    check(abs(v_sum - float(cols["v"].sum())) <=
          1e-12 * float(np.abs(cols["v"]).sum()) + 1e-9,
          "path 3b: v column sum changed")
    print(f"path 3b: {N_ROWS} rows exchanged over {N_SHARDS_RAW} logical "
          f"shards in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; row "
          f"count and column sums kept, every row on shard hash(k) % "
          f"{N_SHARDS_RAW}, no error flag; peak device memory {peak} B; "
          f"launches {launches3b}")
    paths["path 3b"] = {"ms": secs * 1e3, "peak_bytes": peak}
    del out, rb, k, cols
    torch.cuda.empty_cache()

    # ---- the exchange's kernels at path 3b's call (4 shards) ------------
    out, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
        shuffle, "partition_histogram_segments", lambda: recorded(
            shuffle, "partition_positions", raw_exchange)))
    check(sorts == 0, f"path 3b: {sorts} torch.sort calls in _bucket_rows")
    del out, sharded
    torch.cuda.empty_cache()
    (dests, P), (_, _, B, _) = (seen["partition_histogram_segments"],
                                seen["partition_positions"])
    check(len(dests) == N_SHARDS_RAW and P == N_SHARDS_RAW,
          f"path 3b: the exchange counts {len(dests)} segments over {P}")
    ph3b = measure_hist(torch, ck, dests, P, "path 3b shape")
    pp3b = measure_positions(torch, ck, dests, P, B, "path 3b shape")
    del dests
    forget()
    torch.cuda.empty_cache()

    # ---- one shard's send side of the exchange over 8 shards ------------
    # what 3b's cut leaves out on the send side: hash, dest, B4 and the
    # (8, B) send buffers of one 12.5M-row shard, B = 2 x its capacity
    shard = DistContext(devices=[dev] * N_SHARDS).shard_batch(b).shards[0]
    torch.cuda.reset_peak_memory_stats()
    before = dict(ck.LAUNCHES)
    send, counts, error = recorded(
        shuffle, "partition_histogram_segments",
        lambda: shuffle.partition_for_exchange(
            shard, ["k"], N_SHARDS, 2 * shard.capacity))
    peak = torch.cuda.max_memory_allocated()
    for kname in ("partition_histogram", "partition_positions"):
        check(ck.LAUNCHES[kname] - before[kname] == 1,
              f"8-shard send: one shard alone launches {kname} once")
    (dest,), P = seen["partition_histogram_segments"]
    check(dest.shape[0] == N_ROWS // N_SHARDS and P == N_SHARDS,
          f"8-shard send: counted {dest.shape[0]} rows over {P}")
    check(int(counts.sum()) == len(shard) and not bool(error),
          "8-shard send: rows lost or error flag set")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS)(shard.column("k"))
    k_send = send[0]            # leaf 0: the values of column k, (P, B)
    for p in range(N_SHARDS):
        c = int(counts[p])
        check(torch.equal(k_send[p, :c],
                          shard.column("k").values[place == p]),
              f"8-shard send: bucket {p} does not hold its keys in order")
        check(not bool(k_send[p, c:].any()),
              f"8-shard send: bucket {p} is not zero past its rows")
    print(f"8-shard send side, one shard: {len(shard)} rows into "
          f"{N_SHARDS} buckets of {2 * shard.capacity}, each bucket its "
          f"keys in row order; peak device memory {peak} B")
    del send, k_send, place, shard, b
    torch.cuda.empty_cache()
    ph8 = measure_hist(torch, ck, [dest], P, "8-shard send shape")
    del dest
    forget()

    # ---- path 4: arrow_tpu_torch.entry.entry_sort (BASELINE #3) ---------
    from arrow_tpu_torch.entry import example_columns_join, \
        example_columns_sort
    from arrow_tpu_torch.ops import join as join_mod

    def timed(fn, label, must_launch=()):
        """Warm-up run, then the timed, counted run of one path:
        (result, seconds, launches, peak bytes)."""
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ck.LAUNCHES)
        for name in must_launch:
            check(counts[name] > 0,
                  f"{name} was not launched on {label}'s run")
        peak = torch.cuda.max_memory_allocated()
        paths[label] = {"ms": secs * 1e3, "peak_bytes": peak}
        return res, secs, counts, peak

    t0 = time.time()
    cols = example_columns_sort(N_ROWS, NUM_KEYS_SORT, args.seed)
    step, (b,) = entry_mod.entry_sort(dev, N_ROWS, args.seed, NUM_KEYS_SORT)
    torch.cuda.synchronize()
    print(f"path 4 data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    # input 21 B a row; six int64 lanes and three sort words, the sort's
    # keys and indices, the permutation, the taken batch
    print(f"path 4 reckoned: input {N_ROWS * 21} B, lanes and sort words "
          f"{N_ROWS * 8 * 9} B, sort buffers {N_ROWS * 8 * 4} B, output "
          f"{N_ROWS * 29} B")
    (idx, out), secs, launches4, peak = timed(lambda: step(b), "path 4")
    t0 = time.time()
    want = numpy_sort_oracle(cols)
    perm = idx.values.view(torch.int64)
    check(len(idx) == N_ROWS and perm.shape == (N_ROWS,),
          "path 4: the permutation's length")
    check(torch.equal(perm.cpu(), torch.from_numpy(want)),
          "path 4: the permutation differs from numpy's stable sort")
    check(torch.equal(out.column("v").values.cpu(),
                      torch.from_numpy(cols["v"][want])) and
          torch.equal(out.column("k1").values.cpu(),
                      torch.from_numpy(cols["k1"][want])) and
          torch.equal(out.column("k2").validity.cpu(),
                      torch.from_numpy(cols["k2_valid"][want])),
          "path 4: the taken batch")
    print(f"path 4 (sort; second key int32, not a dictionary string): "
          f"{N_ROWS} rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} "
          f"rows/s; the permutation equals numpy's stable sort index for "
          f"index (oracle {time.time() - t0:.1f} s); peak device memory "
          f"{peak} B; launches {launches4}")
    del idx, out, perm, want, cols, b, step
    torch.cuda.empty_cache()

    # ---- paths 5a, 5b: arrow_tpu_torch.entry.entry_join (BASELINE #4) ---
    launches5 = {}
    for label, key_dist in (("path 5a", "uniform"), ("path 5b", "zipf")):
        t0 = time.time()
        bcols, pcols = example_columns_join(N_BUILD, N_ROWS, args.seed,
                                            key_dist)
        step, (bb, pb) = entry_mod.entry_join(dev, N_BUILD, N_ROWS,
                                              args.seed, "inner", key_dist)
        torch.cuda.synchronize()
        print(f"{label} data: {N_BUILD} build and {N_ROWS} probe rows made "
              f"and staged in {time.time() - t0:.1f} s")
        # probe side: three key lanes, the packed key, the seg, take
        # indices, the left plane matrix and its gathered copy, the
        # payload gather, the output
        print(f"{label} reckoned: probe input {N_ROWS * 12} B, work arrays "
              f"{N_ROWS * (24 + 8 + 8 + 4 + 2 * 12 + 8)} B, output "
              f"{N_ROWS * 20} B")
        _, impl = entry_mod.join_routed(step.join, bb)
        check(impl == "packed_u", f"{label} took route {impl!r}")
        (out, tail), secs, counts, peak = timed(
            lambda: step(bb, pb), label,
            ("tile_compact_local", "tile_stitch"))
        launches5[label] = counts
        check(counts["pack_key_lanes"] == 3,
              f"{label}: pack_key_lanes launches (build rows, build segs, "
              f"probe rows): {counts['pack_key_lanes']}")
        check(tail is None, f"{label}: an inner join has no finish output")
        check(peak < 20e9, f"{label}: peak device memory {peak} B")
        t0 = time.time()
        n_out = check_join(torch, dev, label, (out,),
                           numpy_join_oracle(bcols, pcols, "inner"))
        print(f"{label} (inner join, {key_dist} probe keys, route {impl}): "
              f"{N_BUILD} x {N_ROWS} rows in {secs * 1e3:.3f} ms = "
              f"{N_ROWS / secs:.6g} probe rows/s; {n_out} output rows match "
              f"the numpy oracle as a multiset (oracle and compare "
              f"{time.time() - t0:.1f} s); peak device memory {peak} B; "
              f"launches {counts}")
        del out, bcols, pcols
        if key_dist == "uniform":
            # one more run, recording what the probe gives pack_key_lanes;
            # then the kernel at those arguments: error, times, bound
            recorded(join_mod, "pack_key_lanes", lambda: step(bb, pb))
            lanes, lo, span, shift, active = seen["pack_key_lanes"]
            check(len(lanes) == 3 and lanes[0].shape[0] == N_ROWS and
                  active is not None,
                  f"path 5a packed {len(lanes)} lanes of "
                  f"{lanes[0].shape[0]} rows")
            pk = measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                                    "path 5a shape")
            del lanes, active
            forget()
        del bb, pb, step
        torch.cuda.empty_cache()

    # ---- path 5c: the other routes, 10M probe rows ----------------------
    wide_mul = 0x2545F4914F6CDD1D
    cases = (
        ("duplicate build keys", "inner", "packed",
         dict(build_keys=BUILD_KEYS_DUP,
              fanout_capacity=4 * N_PROBE_ROUTES), ()),
        ("two wide keys", "inner", "sort", dict(wide=True), ()),
        ("left semi", "left semi", "packed",
         dict(build_keys=BUILD_KEYS_DUP), ("filter_compact_chunks",)),
        ("left anti", "left anti", "packed",
         dict(build_keys=BUILD_KEYS_DUP), ("filter_compact_chunks",)),
        ("full outer + finish", "full outer", "packed",
         dict(build_keys=BUILD_KEYS_DUP,
              fanout_capacity=4 * N_PROBE_ROUTES),
         ("filter_compact_chunks",)),
        ("left anti, unique build keys", "left anti", "packed_u", {},
         ("tile_compact_local", "tile_stitch")),
    )
    shapes5c = []   # (kernel, label, call, numbers at that call's arguments)
    for name, join_type, want_impl, kw, must in cases:
        label = f"path 5c {name}"
        bcols, pcols = example_columns_join(
            N_BUILD, N_PROBE_ROUTES, args.seed, "uniform",
            kw.get("build_keys"), kw.get("wide", False))
        step, (bb, pb) = entry_mod.entry_join(
            dev, N_BUILD, N_PROBE_ROUTES, args.seed, join_type, **kw)
        _, impl = entry_mod.join_routed(step.join, bb)
        check(impl == want_impl, f"{label} took route {impl!r}")
        outs, secs, counts, peak = timed(lambda: step(bb, pb), label, must)
        launches5[label] = counts
        n_out = check_join(torch, dev, label, outs,
                           numpy_join_oracle(bcols, pcols, join_type),
                           wide_mul if kw.get("wide") else None)
        print(f"{label} ({join_type}, route {impl}): {N_BUILD} x "
              f"{N_PROBE_ROUTES} rows in {secs * 1e3:.3f} ms = "
              f"{N_PROBE_ROUTES / secs:.6g} probe rows/s; {n_out} output "
              f"rows match the numpy oracle as a multiset; peak device "
              f"memory {peak} B; launches {counts}")
        del outs, bcols, pcols
        # one more run, recording what this case gives each kernel it must
        # launch; then every such call's kernel at those arguments: error,
        # times, bound
        def run(names=must):
            if not names:
                return step(bb, pb)
            return recorded(selection, wrapper.get(names[0], names[0]),
                            lambda: run(names[1:]))
        run()
        del bb, pb, step
        for kname in must:
            calls = seen_calls[wrapper.get(kname, kname)]
            check(len(calls) == counts[kname],
                  f"{label}: {len(calls)} recorded calls of {kname}, "
                  f"{counts[kname]} launches")
            for i, a in enumerate(calls):
                at = f"{label} shape" + (f", call {i + 1}" if i else "")
                if kname == "filter_compact_chunks":
                    m = measure_filter(torch, ck, *a, at)
                elif kname == "tile_compact_local":
                    m = measure_tile_compact(torch, ck, *a, at)
                else:
                    m = measure_tile_stitch(torch, ck, *a, at)
                shapes5c.append((kname, label, i, m))
            del calls, a
        forget()
        torch.cuda.empty_cache()

    # ---- path 1b: path 1 on the sorted dense route ----------------------
    t0 = time.time()
    cols = example_columns(N_ROWS, NUM_KEYS_SORTED_DENSE, args.seed)
    step, (b,) = entry_mod.entry(dev, N_ROWS, NUM_KEYS_SORTED_DENSE,
                                 args.seed, MAX_GROUPS_SORTED_DENSE)
    torch.cuda.synchronize()
    print(f"path 1b data: {N_ROWS} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    routes.clear()
    hash_aggregate.HashAggregate.probe_route = route_rec
    try:
        out, secs, launches1b, peak = timed(
            lambda: step(b), "path 1b", ("filter_compact_chunks",))
    finally:
        hash_aggregate.HashAggregate.probe_route = probe_route
    check(all(r[0] == "dense" and r[1]["impl"] == "sorted" for r in routes)
          and launches1b["dense_group_reduce"] == 0,
          f"path 1b took route {routes[-1]!r}")
    n_groups = check_slice(out, numpy_oracle(cols, NUM_KEYS_SORTED_DENSE))
    print(f"path 1b (sorted dense route, G {routes[-1][1]['G']}): {N_ROWS} "
          f"rows in {secs * 1e3:.3f} ms = {N_ROWS / secs:.6g} rows/s; "
          f"{n_groups} groups match the numpy oracle; peak device memory "
          f"{peak} B; launches {launches1b}")
    del out, cols, b, step
    torch.cuda.empty_cache()

    # ---- path 6: the Q3-shaped plan (BASELINE #5), entry_q3 ---------------
    from arrow_tpu_torch.acero import nodes as nodes_mod
    from arrow_tpu_torch.core.batch import Batch
    from arrow_tpu_torch.entry import example_columns_q3
    from arrow_tpu_torch.profile_step import node_layers, node_times
    t0 = time.time()
    qcols = example_columns_q3(N_LINEITEM, args.seed)
    step, tables = entry_mod.entry_q3(dev, N_LINEITEM, args.seed,
                                      Q3_MAX_GROUPS, Q3_BATCH_ROWS)
    torch.cuda.synchronize()
    print(f"path 6 data: {N_LINEITEM} lineitem, "
          f"{tables[1].num_rows} orders, {tables[2].num_rows} customer rows "
          f"in {[len(t.batches) for t in tables]} batches, made and staged "
          f"in {time.time() - t0:.1f} s; input on the card "
          f"{sum(nodes_mod.batch_device_bytes(b) for t in tables for b in t.batches)} B")
    q3_kernels = ("filter_compact_chunks", "tile_compact_local", "tile_stitch",
                  "pack_key_lanes")
    out, secs, launches6, peak = timed(lambda: step(*tables), "path 6",
                                       q3_kernels)
    t0 = time.time()
    q3_oracle = numpy_q3_oracle(*qcols)
    n_groups = check_q3(out, q3_oracle)
    print(f"path 6 (Q3-shaped plan, one card, no dist=): {N_LINEITEM} "
          f"lineitem rows in {secs * 1e3:.3f} ms = {N_LINEITEM / secs:.6g} "
          f"rows/s; the top 10 of {n_groups} groups match the numpy oracle "
          f"(oracle {time.time() - t0:.1f} s); peak device memory {peak} B; "
          f"launches {launches6}")
    del out
    # one more run with each plan node's stream bracketed by CUDA events
    # and its host reads counted
    spans_, reads_, children_, restore = node_layers(torch, nodes_mod, Batch,
                                                     [])
    try:
        step(*tables)
        torch.cuda.synchronize()
    finally:
        restore()
    node_ms = node_times(spans_, reads_, children_)
    for name, m in node_ms.items():
        print(f"path 6 node {name:36s} own {m['own_ms']:10.3f} ms, "
              f"inclusive {m['inclusive_ms']:10.3f} ms, host reads "
              f"{m['host_reads']:.0f}")
    print(json.dumps({"path_6_nodes": node_ms}))
    # one more run, recording every call of the four kernels; each call
    # against its plain version, one full 2^22-row call of each timed
    forget()
    recorded(selection, "filter_compact_columns", lambda: recorded(
        selection, "tile_compact_local", lambda: recorded(
            selection, "tile_stitch", lambda: recorded(
                join_mod, "pack_key_lanes", lambda: step(*tables)))))
    for kname in q3_kernels:
        n_calls = len(seen_calls[wrapper.get(kname, kname)])
        check(n_calls == launches6[kname],
              f"path 6: {n_calls} recorded calls of {kname}, "
              f"{launches6[kname]} launches")
    for a in seen_calls["filter_compact_columns"]:
        check_filter(torch, ck, *a, "path 6 call")
    for (sel,) in seen_calls["tile_compact_local"]:
        check_tile_compact(torch, ck, sel, "path 6 call")
    for a in seen_calls["tile_stitch"]:
        check(torch.equal(ck.tile_stitch(*a), ck.tile_stitch_plain(*a)),
              "path 6: a tile_stitch call differs from its plain version")
    for a in seen_calls["pack_key_lanes"]:
        check_pack_lanes(torch, ck, *a, "path 6 call")

    def full(calls, rows_of):
        """The last call whose rows are a whole 2^22-row batch."""
        return [a for a in calls if rows_of(a) == Q3_BATCH_ROWS][-1]
    sel, columns = full(seen_calls["filter_compact_columns"],
                        lambda a: a[0].shape[0])
    fc6 = measure_filter(torch, ck, sel, columns, "path 6 shape")
    (sel,) = full(seen_calls["tile_compact_local"], lambda a: a[0].shape[0])
    tc6 = measure_tile_compact(torch, ck, sel, "path 6 shape")
    ts6 = measure_tile_stitch(torch, ck, *full(
        seen_calls["tile_stitch"], lambda a: a[0].shape[0]), "path 6 shape")
    lanes, lo, span, shift, active = full(
        [a for a in seen_calls["pack_key_lanes"] if a[4] is not None],
        lambda a: a[0][0].shape[0])
    pk6 = measure_pack_lanes(torch, ck, lanes, lo, span, shift, active,
                             "path 6 shape")
    del sel, columns, lanes, active, step
    forget()
    torch.cuda.empty_cache()

    # ---- path 7b: the Q3 Declaration with dist= on path 6's tables -------
    from arrow_tpu_torch.parallel import DistContext
    dist_kernels = ("filter_compact_chunks", "partition_histogram",
                    "partition_positions", "pack_key_lanes")
    wrapper["partition_histogram"] = "partition_histogram_segments"

    def record_kernels(label, fn):
        """Run fn recording every call of the distributed paths' kernels
        (B1, B4, partition_positions and pack_key_lanes) in ``seen_calls``;
        checks that the exchange ran no torch.sort by destination."""
        _, sorts = bucket_sorts(torch, shuffle, lambda: recorded(
            selection, "filter_compact_columns", lambda: recorded(
                shuffle, "partition_histogram_segments", lambda: recorded(
                    shuffle, "partition_positions", lambda: recorded(
                        join_mod, "pack_key_lanes", fn)))))
        check(sorts == 0, f"{label}: {sorts} torch.sort calls in "
              "_bucket_rows")

    def check_calls(label, counts):
        """Every recorded call of the distributed paths' kernels against
        its plain version; the launches those calls make against the path's
        counted run's."""
        for kname in dist_kernels:
            calls = seen_calls.get(wrapper.get(kname, kname), [])
            n = sum(kernel_launches(ck, kname, a) for a in calls)
            check(n == counts[kname], f"{label}: {len(calls)} recorded calls "
                  f"of {kname} make {n} launches, the counted run "
                  f"{counts[kname]}")
            for a in calls:
                if kname == "filter_compact_chunks":
                    check_filter(torch, ck, *a, f"{label} call")
                elif kname == "partition_histogram":
                    got = ck.partition_histogram_segments(*a)
                    want = ck.partition_histogram_segments_plain(*a)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"{label}: a partition_histogram call differs "
                          "from its plain version")
                    # one launch a shuffle over all the shards of the card
                    check(len(a[0]) == N_SHARDS, f"{label}: a "
                          f"partition_histogram call over {len(a[0])} shards")
                elif kname == "partition_positions":
                    dests, P, B, _ = a
                    check(all(torch.equal(g, w) for g, w in zip(
                        ck.partition_positions(*a),
                        ck.partition_positions_plain(dests, P, B))),
                          f"{label}: a partition_positions call differs "
                          "from its plain version")
                else:
                    check_pack_lanes(torch, ck, *a, f"{label} call", True)
        print(f"{label}: " + ", ".join(
            f"{len(seen_calls.get(wrapper.get(k, k), []))} {k}"
            for k in dist_kernels) + " calls equal their plain versions")

    # no shard's aggregate holds more groups than the whole table's (path
    # 6's max_groups, twice them); the groups each shard held are checked
    # after the run
    ctx7 = DistContext(devices=[dev] * N_SHARDS)

    def q3_dist():
        return entry_mod.q3_declaration(*tables, Q3_MAX_GROUPS,
                                        dist=ctx7).to_table()

    out, secs, launches7b, peak = timed(
        q3_dist, "path 7b", ("filter_compact_chunks", "partition_histogram",
                             "partition_positions"))
    check_q3(out, q3_oracle, "path 7b")
    print(f"path 7b (Q3-shaped plan, dist= over {N_SHARDS} logical shards "
          f"of one card, path 6's tables): {N_LINEITEM} lineitem rows in "
          f"{secs * 1e3:.3f} ms = {N_LINEITEM / secs:.6g} rows/s; the top 10 "
          f"match path 6's numpy oracle; peak device memory {peak} B; "
          f"launches {launches7b}")
    del out
    spans_, reads_, children_, restore = node_layers(torch, nodes_mod, Batch,
                                                     [])
    try:
        q3_dist()
        torch.cuda.synchronize()
    finally:
        restore()
    node_ms7 = node_times(spans_, reads_, children_)
    for name, m in node_ms7.items():
        print(f"path 7b node {name:36s} own {m['own_ms']:10.3f} ms, "
              f"inclusive {m['inclusive_ms']:10.3f} ms, host reads "
              f"{m['host_reads']:.0f}")
    print(json.dumps({"path_7b_nodes": node_ms7}))
    # one more run: every B1, B4 and pack_key_lanes call recorded and held
    # against its plain version, and the groups each shard's aggregate held
    forget()
    finalize_table = dist_agg.DistGroupBy.finalize_table
    held = []

    def finalize_rec(self, state):
        held.append([int(st[0].num_groups) for st in state])
        return finalize_table(self, state)
    dist_agg.DistGroupBy.finalize_table = finalize_rec
    try:
        record_kernels("path 7b", q3_dist)
    finally:
        dist_agg.DistGroupBy.finalize_table = finalize_table
    print(f"path 7b: groups a shard held {held[-1]}, max_groups "
          f"{Q3_MAX_GROUPS} a shard")
    check(max(held[-1]) * 2 <= Q3_MAX_GROUPS,
          f"path 7b: a shard held {max(held[-1])} groups")
    check_calls("path 7b", launches7b)
    sel, columns = full(seen_calls["filter_compact_columns"],
                        lambda a: a[0].shape[0])
    fc7b = measure_filter(torch, ck, sel, columns, "path 7b shape")
    hist_calls = seen_calls["partition_histogram_segments"]
    pos_calls = seen_calls["partition_positions"]
    check(len(hist_calls) == len(pos_calls) and all(
        h[0] is p[0] for h, p in zip(hist_calls, pos_calls)),
        "path 7b: each shuffle's positions call takes its histogram's dests")

    def fullest(i):
        """Of the shuffles whose shards hold ``rows`` rows each, the call
        whose dests send the most rows (a shard whose block of a batch is
        padding sends none)."""
        return max(i, key=lambda j: sum(int((d < hist_calls[j][1]).sum())
                                        for d in hist_calls[j][0]))
    # a lineitem batch's probe shuffle: 8 x 2^19 rows; the state-row
    # exchange: the last shuffle, 8 x 2^22 rows
    shape7b = {}
    for label, rows, idx in (
            ("path 7b lineitem shuffle", Q3_BATCH_ROWS // N_SHARDS,
             [j for j, a in enumerate(hist_calls)
              if a[0][0].shape[0] == Q3_BATCH_ROWS // N_SHARDS]),
            ("path 7b state rows", Q3_MAX_GROUPS, [len(hist_calls) - 1])):
        j = fullest(idx)
        dests, P = hist_calls[j]
        check(all(d.shape[0] == rows for d in dests),
              f"{label}: shards of {[d.shape[0] for d in dests]} rows")
        shape7b[label] = (measure_hist(torch, ck, dests, P, label),
                          measure_positions(torch, ck, dests, P,
                                            pos_calls[j][2], label))
    (ph7b, pp7b), (ph7b_state, pp7b_state) = shape7b.values()
    # one shard's build of the orders: its 25M-row accumulation's keys
    n_orders = tables[1].num_rows
    pk7b = measure_pack_lanes(torch, ck, *[
        a for a in seen_calls["pack_key_lanes"]
        if a[4] is None and a[0][0].shape[0] == n_orders][0],
        "path 7b orders build")
    del sel, columns, hist_calls, pos_calls, dests, tables, qcols, ctx7
    forget()
    torch.cuda.empty_cache()

    # ---- path 6b: a Declaration whose join runs the Bloom pushdown -------
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       HashJoinNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.compute.expressions import field, literal
    from arrow_tpu_torch.entry import table_from_numpy
    bcols, pcols = example_columns_join(N_BUILD, N_PROBE_ROUTES, args.seed,
                                        "uniform", None, True)
    probe_t = table_from_numpy(pcols, Q3_BATCH_ROWS, dev)
    build_t = table_from_numpy(bcols, Q3_BATCH_ROWS, dev)
    keys = ["k", "k2"]

    def join_6b():
        return Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=keys, right_keys=keys,
            left_output=keys + ["lv"], right_output=["rv"],
            max_build_rows=N_BUILD), [
                Declaration.from_sequence([
                    Declaration("table_source",
                                TableSourceNodeOptions(probe_t)),
                    Declaration("filter", FilterNodeOptions(
                        field("lv") > literal(BLOOM_LV_MIN)))]),
                Declaration("table_source",
                            TableSourceNodeOptions(build_t))]).to_table()

    bloom_builds = []
    bloom_build = join_mod.HashJoin.bloom_build

    def counted_bloom(self, bs):
        bloom_builds.append(1)
        return bloom_build(self, bs)
    join_mod.HashJoin.bloom_build = counted_bloom
    try:
        table6b, secs, launches6b, peak = timed(join_6b, "path 6b",
                                                ("filter_compact_chunks",))
    finally:
        join_mod.HashJoin.bloom_build = bloom_build
    n_batches = len(probe_t.batches)
    check(len(bloom_builds) == 2, "path 6b: the Bloom bits were not built "
          "on each run")
    check(launches6b["filter_compact_chunks"] == 2 * n_batches,
          f"path 6b: {launches6b['filter_compact_chunks']} compaction "
          f"launches, not the filter's and the Bloom split's {n_batches} each")
    keep = pcols["lv"] > BLOOM_LV_MIN
    n_out = check_join(torch, dev, "path 6b", table6b.batches,
                       numpy_join_oracle(bcols, {n: v[keep] for n, v in
                                                 pcols.items()}, "inner"),
                       wide_mul)
    print(f"path 6b (filter -> hashjoin on two wide keys, route sort, Bloom "
          f"pushdown): {N_BUILD} x {N_PROBE_ROUTES} rows in {n_batches} "
          f"batches in {secs * 1e3:.3f} ms = {N_PROBE_ROUTES / secs:.6g} probe "
          f"rows/s; {n_out} output rows match the numpy oracle as a "
          f"multiset; peak device memory {peak} B; launches {launches6b}")
    del table6b, bcols, pcols
    recorded(selection, "filter_compact_columns", join_6b)
    calls = seen_calls["filter_compact_columns"]
    for a in calls:
        check_filter(torch, ck, *a, "path 6b call")
    # the calls alternate: a batch's filter, then its Bloom split
    fc6b = measure_filter(torch, ck, *calls[1], "path 6b Bloom split shape")
    del calls, probe_t, build_t
    forget()
    torch.cuda.empty_cache()

    # ---- path 7a: entry.dryrun_multichip over 8 logical shards ----------
    t0 = time.perf_counter()
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    dry = entry_mod.dryrun_multichip(N_SHARDS, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches7a = dict(ck.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in ("filter_compact_chunks", "partition_histogram",
                 "partition_positions"):
        check(launches7a[name] > 0, f"{name} was not launched on path 7a")
    check(all(t.device.type == "cuda" for t in dry["q3"].batches),
          "path 7a: the Q3 result is not on the card")
    paths["path 7a"] = {"ms": secs * 1e3, "peak_bytes": peak}
    print(f"path 7a (dryrun_multichip({N_SHARDS}) on logical shards of the "
          f"card: group-by, join, sort, one hot key, Q3 with dist=): all five "
          f"checks pass in {secs * 1e3:.3f} ms (the first run: no warm-up); "
          f"peak device memory {peak} B; launches {launches7a}")
    del dry
    # one more run, every kernel call recorded and held against its plain
    # version
    record_kernels("path 7a",
                   lambda: entry_mod.dryrun_multichip(N_SHARDS, dev))
    check_calls("path 7a", launches7a)
    forget()

    # ---- path 7c: DistContext.join, BASELINE #4's shape cut to 25M -------
    t0 = time.time()
    bcols, pcols = example_columns_join(N_BUILD, N_PROBE_DIST, args.seed)
    step, (bb, pb) = entry_mod.entry_dist_join(dev, N_SHARDS, N_BUILD,
                                               N_PROBE_DIST, args.seed)
    torch.cuda.synchronize()
    print(f"path 7c data: {N_BUILD} build and {N_PROBE_DIST} probe rows "
          f"made and staged in {time.time() - t0:.1f} s")
    # probe side: send, stacked receive and compaction, 16 x the local
    # capacity rows a shard at 14 B (k, lv and their validity)
    print(f"path 7c reckoned: probe exchange buffers 3 x {2 * N_PROBE_DIST} "
          f"rows x 14 B = {3 * 2 * N_PROBE_DIST * 14} B (100M probe rows: "
          f"{3 * 2 * 100_000_000 * 14} B, with the build's and the "
          f"outputs more)")
    table7c, secs, launches7c, peak = timed(
        lambda: step(bb, pb), "path 7c", ("partition_histogram",
                                          "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches7c[kname] == 2,
              f"path 7c: {launches7c[kname]} {kname} launches, not one a "
              "side")
    check(len(table7c.batches) == N_SHARDS, "path 7c: a shard has no rows")
    place = shard_of(shuffle.EXCHANGE_SEED, N_SHARDS)
    for p, rb in enumerate(table7c.batches):
        check(bool((place(rb.column("k"))[:len(rb)] == p).all()),
              f"path 7c: a row of shard {p} hashes elsewhere")
    t0 = time.time()
    n_out = check_join(torch, dev, "path 7c", table7c.batches,
                       numpy_join_oracle(bcols, pcols, "inner"))
    print(f"path 7c (DistContext.join inner over {N_SHARDS} logical shards, "
          f"route sort; probe cut to {N_PROBE_DIST} rows): {N_BUILD} x "
          f"{N_PROBE_DIST} rows in {secs * 1e3:.3f} ms = "
          f"{N_PROBE_DIST / secs:.6g} probe rows/s; {n_out} output rows match "
          f"the numpy oracle as a multiset (oracle {time.time() - t0:.1f} s), "
          f"each on the shard its key's hash names; peak device memory "
          f"{peak} B; launches {launches7c}")
    del table7c, bcols, pcols
    record_kernels("path 7c", lambda: step(bb, pb))
    check_calls("path 7c", launches7c)
    # the probe side's shuffle, the larger: 8 shards of 3,125,000 rows
    j = max(range(len(seen_calls["partition_positions"])),
            key=lambda i: seen_calls["partition_positions"][i][0][0].shape[0])
    dests, P, B, _ = seen_calls["partition_positions"][j]
    check(dests[0].shape[0] >= N_PROBE_DIST // N_SHARDS,
          f"path 7c: the probe shuffle's shards hold {dests[0].shape[0]} "
          "rows")
    ph7c = measure_hist(torch, ck, dests, P, "path 7c probe shuffle")
    pp7c = measure_positions(torch, ck, dests, P, B, "path 7c probe shuffle")
    del dests
    forget()
    del bb, pb, step
    torch.cuda.empty_cache()

    # ---- path 7d: DistContext.sort_by, BASELINE #3's columns cut to 25M --
    t0 = time.time()
    cols = example_columns_sort(N_SORT_DIST, NUM_KEYS_SORT, args.seed)
    step, (b,) = entry_mod.entry_dist_sort(dev, N_SHARDS, N_SORT_DIST,
                                           args.seed, NUM_KEYS_SORT,
                                           SORT_BUCKET_FACTOR)
    torch.cuda.synchronize()
    print(f"path 7d data: {N_SORT_DIST} rows made and staged in "
          f"{time.time() - t0:.1f} s")
    print(f"path 7d reckoned: exchange buffers 3 x "
          f"{SORT_BUCKET_FACTOR * N_SORT_DIST} rows x 21 B = "
          f"{3 * SORT_BUCKET_FACTOR * N_SORT_DIST * 21} B (100M rows: "
          f"{3 * SORT_BUCKET_FACTOR * 100_000_000 * 21} B)")
    table7d, secs, launches7d, peak = timed(
        lambda: step(b), "path 7d", ("partition_histogram",
                                     "partition_positions"))
    for kname in ("partition_histogram", "partition_positions"):
        check(launches7d[kname] == 1,
              f"path 7d: {launches7d[kname]} {kname} launches, not one")
    t0 = time.time()
    want = torch.from_numpy(numpy_sort_oracle(cols))
    got = {c: torch.cat([x.column(c).values[:len(x)] for x in
                         table7d.batches]).cpu() for c in ("k1", "k2", "v")}
    got_valid = torch.cat([x.column("k2").validity[:len(x)]
                           for x in table7d.batches]).cpu()
    check(got["v"].shape[0] == N_SORT_DIST, "path 7d: the row count")
    check(torch.equal(got["k1"], torch.from_numpy(cols["k1"])[want]) and
          torch.equal(got["v"], torch.from_numpy(cols["v"])[want]) and
          torch.equal(got_valid, torch.from_numpy(cols["k2_valid"])[want]),
          "path 7d: the rows differ from numpy's stable sort's")
    ok = got_valid
    check(torch.equal(got["k2"][ok], torch.from_numpy(cols["k2"])[want][ok]),
          "path 7d: k2")
    lengths7d = [len(x) for x in table7d.batches]
    print(f"path 7d (DistContext.sort_by over {N_SHARDS} logical shards, "
          f"bucket factor {SORT_BUCKET_FACTOR}; cut to {N_SORT_DIST} rows): "
          f"{N_SORT_DIST} rows in {secs * 1e3:.3f} ms = "
          f"{N_SORT_DIST / secs:.6g} rows/s; the shards in order equal "
          f"numpy's stable sort row for row (oracle {time.time() - t0:.1f} "
          f"s); shard lengths {lengths7d}; peak device memory {peak} B; "
          f"launches {launches7d}")
    del table7d, got, got_valid, want, cols
    record_kernels("path 7d", lambda: step(b))
    check_calls("path 7d", launches7d)
    (dests, P), (_, _, B, _) = (seen["partition_histogram_segments"],
                                seen["partition_positions"])
    ph7d = measure_hist(torch, ck, dests, P, "path 7d sort shuffle")
    pp7d = measure_positions(torch, ck, dests, P, B, "path 7d sort shuffle")
    del dests
    forget()
    del b, step
    torch.cuda.empty_cache()

    def row(name, source, replaces, n_launches, m):
        return {"name": name, "route": "cuda",
                "source": f"arrow_tpu_torch/csrc/{source}",
                "replaces": f"arrow_tpu/{replaces}",
                "launches": n_launches, "max_abs_err": m["max_abs_err"],
                "ms": m["ms"], "plain_ms": m["plain_ms"],
                "bound_ms": m["bound_ms"], "bound_by": "bytes",
                "library_ms": m["library_ms"]}

    def also(kernel, suffix, m, n_launches=None):
        """The same numbers at a further path's arguments; the launches of
        that path's counted run, where it has one."""
        if n_launches is not None:
            kernel[f"launches_{suffix}"] = n_launches
        for key, value in m.items():
            kernel[f"{key}_{suffix}"] = value

    kernels = [
        row("filter_compact_chunks", "filter_compact.cu",
            "ops/pallas_kernels.py:492", launches["filter_compact_chunks"],
            fc),
        row("dense_group_reduce", "dense_group.cu",
            "ops/pallas_kernels.py:327", launches["dense_group_reduce"], dg),
        row("tile_compact_local", "tile_compact.cu",
            "ops/pallas_kernels.py:392", launches2["tile_compact_local"], tc),
        row("tile_stitch", "tile_compact.cu", "ops/selection.py:102",
            launches2["tile_stitch"], ts),
        row("partition_histogram", "partition_hist.cu",
            "ops/pallas_kernels.py:76", launches3["partition_histogram"], ph),
        row("pack_key_lanes", "pack_lanes.cu", "ops/join.py:157",
            launches5["path 5a"]["pack_key_lanes"], pk),
        # the stable sort by destination of the JAX exchange's send side
        row("partition_positions", "partition_hist.cu",
            "parallel/shuffle.py:155", launches3["partition_positions"], pp),
    ]
    kernels[1]["bound_ms_all_rows"] = dg["bound_ms_all_rows"]
    also(kernels[1], "nine_kinds", dg9)
    kernels[2]["take_indices_ms"] = ti_ms
    kernels[4]["host_ms"] = ph["host_ms"]
    also(kernels[0], "path_3a", fc3a, launches3["filter_compact_chunks"])
    also(kernels[0], "one_matrix_100M", fc_matrix)
    kernels[0]["filter_layer_ms_path_1"] = paths["path 1"]["filter_layer_ms"]
    also(kernels[4], "path_3b", ph3b, launches3b["partition_histogram"])
    also(kernels[4], "send_8_shards", ph8)
    kernels[6]["host_ms"] = pp["host_ms"]
    also(kernels[6], "path_3b", pp3b, launches3b["partition_positions"])
    def suffix_of(label):
        return label.replace(" ", "_").replace(",", "").replace("+", "and")

    # path 5c's kernels at its calls' arguments
    for kname, label, i, m in shapes5c:
        kernel = next(k for k in kernels if k["name"] == kname)
        also(kernel, suffix_of(label) + (f"_call_{i + 1}" if i else ""), m)
    # path 6's and 6b's kernels at their 2^22-row calls
    for kernel, m in ((kernels[0], fc6), (kernels[2], tc6), (kernels[3], ts6),
                      (kernels[5], pk6)):
        also(kernel, "path_6", m)
    also(kernels[0], "path_6b_bloom_split", fc6b)
    also(kernels[0], "path_7b", fc7b)
    for kernel, suffix, m in (
            (kernels[4], "path_7b", ph7b), (kernels[6], "path_7b", pp7b),
            (kernels[4], "path_7b_state_rows", ph7b_state),
            (kernels[6], "path_7b_state_rows", pp7b_state),
            (kernels[4], "path_7c", ph7c), (kernels[6], "path_7c", pp7c),
            (kernels[4], "path_7d", ph7d), (kernels[6], "path_7d", pp7d)):
        also(kernel, suffix, m)
    also(kernels[5], "path_7b_orders_build", pk7b)
    # the launches of the join paths', path 1b's and path 6's counted runs
    for label, counts in list(launches5.items()) + [
            ("path 1b", launches1b), ("path 6", launches6),
            ("path 6b", launches6b), ("path 7a", launches7a),
            ("path 7b", launches7b), ("path 7c", launches7c),
            ("path 7d", launches7d)]:
        suffix = suffix_of(label)
        for kernel in kernels:
            if counts[kernel["name"]] and not (
                    label == "path 5a" and kernel["name"] == "pack_key_lanes"):
                kernel[f"launches_{suffix}"] = counts[kernel["name"]]
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
