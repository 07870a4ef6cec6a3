"""Time the port's TPC-H Q7 (``entry_q7``) and the run-end encoding of
``l_orderkey`` (``entry_ree_keys``) at SF 10 on the card, with
``arrow_tpu_torch`` imported from ``--root``, so that two trees of the
port can be held against each other on one card, one after the other:

    python3 tools/torch_take_reads_ab.py --root PARENT_TREE
    python3 tools/torch_take_reads_ab.py --root .

Both steps run over one generation of the tables (``--sf``, ``--seed``;
``--device cpu --sf 0.01`` tries the script without a card), after one
warm-up each; every step is synchronized and timed on the host
clock. Where the tree has ``selection.take_arrays`` (one host read of the
byte totals of a take's varlen columns), its calls that read are counted.
``--only`` runs one of the two; ``--profile`` adds one step of each under
``torch.profiler``: the sum of its kernels' device time. Prints the
card's name and power limit, then one JSON line: each step's ms and the
reads a step."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--only", choices=("q7", "ree"), default=None)
    ap.add_argument("--profile", action="store_true",
                    help="one more step of each under torch.profiler: the "
                    "kernels' device ms")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_take_reads_ab: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, check=True).stdout.strip())
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    from arrow_tpu_torch import entry as entry_mod
    from arrow_tpu_torch.ops import selection

    reads = [0]
    if hasattr(selection, "take_arrays"):
        from arrow_tpu_torch.ops import join
        inner = selection.take_arrays

        def take_arrays(columns, indices):
            reads[0] += any(c.type.is_varlen for c in columns)
            return inner(columns, indices)
        selection.take_arrays = join.take_arrays = take_arrays

    t0 = time.time()
    steps, source = [], None
    if args.only in (None, "q7"):
        q7, q7_tables = entry_mod.entry_q7(dev, args.sf, args.seed)
        steps.append(("q7", q7, q7_tables))
        source = q7.source
    if args.only in (None, "ree"):
        ree, ree_tables = entry_mod.entry_ree_keys(dev, args.sf, args.seed,
                                                  source=source)
        steps.append(("ree", ree, ree_tables))
    out = {"root": root, "tables_s": time.time() - t0}
    for name, step, tables in steps:
        step(*tables)
        sync()
        ms, n_reads = [], []
        for _ in range(args.steps):
            reads[0] = 0
            t = time.perf_counter()
            step(*tables)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
            n_reads.append(reads[0])
        out[name] = {"ms": ms, "take_reads": n_reads}
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                step(*tables)
                sync()
            out[name]["kernels_ms"] = sum(
                e.self_device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA") / 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
