"""Time path 6's Q3 of ``chip_smoke.py`` (100M lineitem, 25M orders, 2.5M
customer rows in 2^22-row batches) on the card through the fused driver
with ``acero.fuse.MIN_REPLAYS`` at each value of ``--min-replays``, in an
order that alternates from one repetition to the next, and through the
eager driver beside them:

    python3 tools/torch_fused_q3_ab.py [--min-replays 1 2] [--reps 3]

Each run builds a fresh Declaration over one staging of the tables and is
timed on the host clock up to ``torch.cuda.synchronize()``, after one
warm-up run of each driver (the fused one learns its probe routes there).
For each fused run it reports the graphs captured and replayed and the
host ms spent in ``capture_graph`` (the synchronisation that
``torch.cuda.graph`` makes included). One more run of each setting counts
its synchronising CUDA operations (torch's sync debug mode) and names the
line of the port that made each one. ``--lineitem 1048576 --device cpu``
tries the script without a card. Prints the card's name and power limit,
one line a run, then one JSON line."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sync_sites(torch, fn):
    """(fn(), Counter of the port's file:line that made each synchronising
    CUDA operation): torch's sync debug mode warns at each one."""
    sites: Counter = Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "arrow_tpu_torch" in f.filename]
        at = frames[-1] if frames else None
        sites[f"{os.path.relpath(at.filename, ROOT)}:{at.lineno}"
              if at else "outside the port"] += 1
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return res, sites


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lineitem", type=int, default=100_000_000)
    ap.add_argument("--batch-rows", type=int, default=1 << 22)
    ap.add_argument("--max-groups", type=int, default=1 << 22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--min-replays", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    from arrow_tpu_torch.acero import fuse
    from arrow_tpu_torch.entry import entry_q3, plan_driver, q3_declaration
    from arrow_tpu_torch.ops import cuda_kernels as ck
    on_card = args.device != "cpu"
    if on_card:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
        ck.build()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    _, tables = entry_q3(args.device, args.lineitem, args.seed,
                         args.max_groups, args.batch_rows)
    sync()
    captures = []
    inner = ck.capture_graph

    def timed_capture(fn):
        t0 = time.perf_counter()
        try:
            return inner(fn)
        finally:
            captures.append((time.perf_counter() - t0) * 1e3)
    ck.capture_graph = timed_capture

    def run(driver, m=None):
        if m is not None:
            fuse.MIN_REPLAYS = m
        fuse.reset_stats()
        captures.clear()
        sync()
        t0 = time.perf_counter()
        t = plan_driver(q3_declaration(*tables, args.max_groups), driver)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        return t, {"ms": ms, "graphs": fuse.STATS["graphs"],
                   "replays": fuse.STATS["replays"],
                   "fallbacks": fuse.STATS["fallbacks"],
                   "capture_ms": list(captures)}

    want = run("eager")[0].to_pydict()
    for m in args.min_replays:
        got = run("fused", m)[0].to_pydict()
        assert all(abs(a - b) <= 1e-9 * abs(b) for a, b in
                   zip(got["revenue"], want["revenue"])), (m, got, want)
    runs = []
    for r in range(args.reps):
        order = list(args.min_replays)
        if r % 2:
            order.reverse()
        for d, m in [("eager", None)] + [("fused", m) for m in order]:
            _, rep = run(d, m)
            rep.update(driver=d, min_replays=m, rep=r)
            runs.append(rep)
            print(json.dumps(rep))
    sites = {}
    if on_card:
        for d, m in [("eager", None)] + [("fused", m)
                                         for m in args.min_replays]:
            _, s = sync_sites(torch, lambda: run(d, m))
            sites[f"{d} {m}"] = dict(s)
            print(f"{d} min_replays {m}: {sum(s.values())} synchronising "
                  f"operations: {dict(s)}")
    print(json.dumps({"runs": runs, "syncs": sites}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
