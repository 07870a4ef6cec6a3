#!/usr/bin/env python3
"""Smoke test of the PyTorch port (arrow_tpu_torch) on one NVIDIA GPU.

Builds the CUDA kernels from csrc/, checks each kernel against its plain
PyTorch version on the card, then drives the two slices of the port at
100M rows (BASELINE config #2) and checks each result against a numpy
oracle:

  path 1  ``arrow_tpu_torch.entry.entry``: compaction-kernel filter ->
          dense group-by kernel (1K distinct int64 keys, float32 values);
  path 2  ``arrow_tpu_torch.entry.entry_generic``: take-index filter on the
          tile-compaction kernel -> sort-grouping consume (3M distinct
          keys, float64 values, 4M-slot state).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Prints the card's name and power limit, one line per check, a JSON line
``{"kernels": [...]}`` with each kernel's launches on its path's counted
run, its error against the plain version, its time, the plain version's,
the least time the card could take (``bound_ms``: bytes moved over the
memory rate) and the time of one PyTorch call computing the same function
(``library_ms``, null where there is none), and last ``{"ok": true,
"device": {...}}``. Exits non-zero, printing no result, when there is no
CUDA device or any check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def check_take_indices(torch, selection, Array, bool_type, sel,
                       label: str) -> None:
    """get_take_indices (kernel + stitch) vs torch.nonzero."""
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


def check_filter(torch, ck, sel, chunks, label: str) -> float:
    """Kernel vs plain version: same count, same first rows. Returns the
    max abs error over the compared rows (0 when equal)."""
    got = ck.filter_compact_chunks(sel, chunks)
    want = ck.filter_compact_chunks_plain(sel, chunks)
    n = int(sel.sum())
    err = 0.0
    if n:
        err = float((got[:n].int() - want[:n].int()).abs().max())
    check(err == 0, f"filter_compact_chunks {label}: rows differ")
    print(f"filter_compact_chunks {label}: cap={sel.shape[0]} "
          f"C={chunks.shape[1]} selected={n} equal")
    return err


def dg_compare(torch, ck, gid, inputs, kinds, G, label: str) -> float:
    """Kernel vs plain version slot for slot: integers and f32 min/max
    exact (NaN equal to NaN), f32 sums within the stated tolerance.
    Returns the max abs error over the f32 sums (0 elsewhere)."""
    rows, outs = ck.dense_group_reduce(gid, inputs, kinds, G)
    prows, pouts = ck.dense_group_reduce_plain(gid, inputs, kinds, G)
    check(torch.equal(rows, prows), f"dense_group_reduce {label}: rows")
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()
    err = 0.0
    oi = ij = 0
    for kind in kinds:
        ni, no = ck._DG_ARITY[kind]
        for j in range(no):
            a, b = outs[oi + j], pouts[oi + j]
            if kind == "sum":
                absum = torch.zeros(G + 1, dtype=torch.float64,
                                    device=gid.device).index_add_(
                    0, slot, inputs[ij].double().abs())[:G]
                d = (a.double() - b.double()).abs()
                err = max(err, float(d.max()))
                check(bool((d <= SUM_RTOL * absum + SUM_ATOL_KERNEL).all()),
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
    """Every kind once; gid in [-1, G + 8): inactive rows, rows past G,
    and one slot whose f32 inputs hold a NaN."""
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


def numpy_oracle(cols):
    """Group-by of the slice computed independently with numpy: per key
    (first-appearance order) count, sums (float64 bincount), mins (sort)."""
    sel = cols["w"] > 0
    k, v, w = cols["k"][sel], cols["v"][sel], cols["w"][sel]
    keys, first = np.unique(k, return_index=True)
    keys = keys[np.argsort(first, kind="stable")]
    cnt = np.bincount(k, minlength=NUM_KEYS)
    v_sum = np.bincount(k, weights=v.astype(np.float64), minlength=NUM_KEYS)
    v_abs = np.bincount(k, weights=np.abs(v).astype(np.float64),
                        minlength=NUM_KEYS)
    w_sum = np.bincount(k, weights=w.astype(np.float64), minlength=NUM_KEYS)
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    v_min = np.full(NUM_KEYS, np.inf, np.float32)
    w_min = np.zeros(NUM_KEYS, np.int64)
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

    # ---- filter_compact_chunks against its plain version ---------------
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for cap in (1000, 256 * 4096):
        chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                               dtype=torch.uint8)
        for name, sel in (
                ("half", torch.rand(cap, generator=gen, device=dev) < 0.5),
                ("none", torch.zeros(cap, dtype=torch.bool, device=dev)),
                ("all", torch.ones(cap, dtype=torch.bool, device=dev))):
            check_filter(torch, ck, sel, chunks, name)
    cap = N_ROWS
    chunks = torch.randint(0, 256, (cap, 20), generator=gen, device=dev,
                           dtype=torch.uint8)
    for name, sel in (("none", torch.zeros(cap, dtype=torch.bool,
                                           device=dev)),
                      ("all", torch.ones(cap, dtype=torch.bool,
                                         device=dev))):
        check_filter(torch, ck, sel, chunks, name)
    del chunks, sel

    # ---- tile_compact_local against its plain version ------------------
    padded = N_ROWS + (-N_ROWS) % ck.TILE_ROWS
    for cap in (1024, 1 << 20, padded):
        for name, sel in (
                ("half", torch.rand(cap, generator=gen, device=dev) < 0.5),
                ("none", torch.zeros(cap, dtype=torch.bool, device=dev)),
                ("all", torch.ones(cap, dtype=torch.bool, device=dev))):
            check_tile_compact(torch, ck, sel, name)
    for cap in (1000, N_ROWS):
        sel = torch.rand(cap, generator=gen, device=dev) < 0.5
        check_take_indices(torch, selection, Array, datatype.bool_, sel,
                           "half")
    del sel

    # ---- dense_group_reduce against its plain version ------------------
    for G in (128, 1024, 4096):
        gid, inputs, kinds = synthetic_dg_inputs(torch, 1 << 20, G, gen, dev)
        dg_compare(torch, ck, gid, inputs, kinds, G, f"all kinds G={G}")
    del gid, inputs

    # ---- path 1: arrow_tpu_torch.entry.entry ----------------------------
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
    del out, cols

    # one more run, recording the arguments each kernel gets on the path
    seen = {}

    def recorded(mod, name, fn):
        """Run fn with mod.name wrapped to record its arguments."""
        inner = getattr(mod, name)

        def rec(*a):
            seen[name] = a
            return inner(*a)
        setattr(mod, name, rec)
        try:
            return fn()
        finally:
            setattr(mod, name, inner)

    recorded(selection, "filter_compact_chunks", lambda: recorded(
        hash_aggregate, "dense_group_reduce", lambda: step(b)))
    del b, step

    # ---- path 1's kernels at its shapes: error, times, bound ------------
    sel, chunks = seen["filter_compact_chunks"]
    fc_err = check_filter(torch, ck, sel, chunks, "path 1 shape")
    fc_ms = cuda_ms(torch, lambda: ck.filter_compact_chunks(sel, chunks), 10)
    fc_plain = cuda_ms(torch,
                       lambda: ck.filter_compact_chunks_plain(sel, chunks), 3)
    fc_lib = cuda_ms(torch, lambda: chunks[sel], 3)
    cap, C = chunks.shape
    # selection and planes read once, the selected rows written once
    fc_bound = bound_ms(cap + cap * C + int(sel.sum()) * C)
    del sel, chunks
    gid, inputs, kinds, G = seen["dense_group_reduce"]
    dg_err = dg_compare(torch, ck, gid, inputs, kinds, G, "path 1 shape")
    dg_ms = cuda_ms(torch, lambda: ck.dense_group_reduce(gid, inputs, kinds,
                                                         G), 10)
    dg_plain = cuda_ms(torch, lambda: ck.dense_group_reduce_plain(
        gid, inputs, kinds, G), 3)
    n_outs = 1 + sum(ck._DG_ARITY[k][1] for k in kinds)
    # gid and every input stream read once, every (G,) output written once
    dg_bound = bound_ms(4 * gid.shape[0] * (1 + len(inputs)) + 4 * G * n_outs)
    del gid, inputs
    seen.clear()

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
    check(launches2["tile_compact_local"] > 0,
          "tile_compact_local was not launched on path 2's run")
    n_groups = check_slice_generic(
        out, numpy_oracle_generic(cols, NUM_KEYS_GENERIC))
    del out, cols

    # one more run, recording the kernel's argument and the route taken
    routes = []
    probe_route = hash_aggregate.HashAggregate.probe_route

    def route_rec(self, batch, vals):
        routes.append(probe_route(self, batch, vals))
        return routes[-1]
    hash_aggregate.HashAggregate.probe_route = route_rec
    try:
        recorded(selection, "tile_compact_local", lambda: step(b))
    finally:
        hash_aggregate.HashAggregate.probe_route = probe_route
    check(len(routes) == 1, "path 2: one probe per step")
    route = routes[0][0]
    check(route in ("packed", "generic"), f"path 2 took route {route!r}")
    print(f"path 2: {N_ROWS} rows in {secs * 1e3:.3f} ms = "
          f"{N_ROWS / secs:.6g} rows/s; route {route}; {n_groups} groups "
          f"match the numpy oracle; peak device memory {peak} B; launches "
          f"{launches2}")
    del b, step

    # ---- path 2's kernel at its shape: error, times, bound --------------
    (sel,) = seen["tile_compact_local"]
    tc_err = check_tile_compact(torch, ck, sel, "path 2 shape")
    tc_ms = cuda_ms(torch, lambda: ck.tile_compact_local(sel), 10)
    tc_plain = cuda_ms(torch, lambda: ck.tile_compact_local_plain(sel), 3)
    # the library call gives the END result (kernel + stitch), so the
    # whole of get_take_indices is timed beside it too
    tc_lib = cuda_ms(torch, lambda: torch.nonzero(sel), 3)
    mask = Array(datatype.bool_, sel[:N_ROWS])
    ti_ms = cuda_ms(torch, lambda: selection.get_take_indices(mask), 3)
    cap = sel.shape[0]
    # selection read once, loc and counts written once
    tc_bound = bound_ms(cap + 4 * cap + 4 * (cap // ck.TILE_ROWS))
    del sel, mask

    def row(name, source, replaces, n_launches, err, ms, plain, bound, lib):
        return {"name": name, "route": "cuda",
                "source": f"arrow_tpu_torch/csrc/{source}",
                "replaces": f"arrow_tpu/ops/pallas_kernels.py:{replaces}",
                "launches": n_launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
                "library_ms": lib}

    kernels = [
        row("filter_compact_chunks", "filter_compact.cu", 492,
            launches["filter_compact_chunks"], fc_err, fc_ms, fc_plain,
            fc_bound, fc_lib),
        row("dense_group_reduce", "dense_group.cu", 327,
            launches["dense_group_reduce"], dg_err, dg_ms, dg_plain,
            dg_bound, None),
        row("tile_compact_local", "tile_compact.cu", 392,
            launches2["tile_compact_local"], tc_err, tc_ms, tc_plain,
            tc_bound, tc_lib),
    ]
    kernels[2]["take_indices_ms"] = ti_ms
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
