"""Readings that a cell's limits are set from, at the cell's own size.

    python3 -m qbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's tables, the warm-up, then the
first ``QUERIES`` queries of the window's stream for that seed through the
port (the timed path: ``Declaration.to_table()``), each answer held against
the float64 reference (the program's reading); and the control: the same
reference computed in float32, the nearest precision below the
configuration's float64, put in the program's place and held against the
float64 reference the same way. Prints one JSON line a seed with
``mismatches`` and ``rel_err`` of both, overall and by query. The benchmark's
runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

QUERIES = 6


def readings(bench: dict, workload: str, seed: int, device) -> dict:
    import torch

    from qbench import catalog, check, traffic
    from qbench.run import Cell
    c = Cell(bench, workload, seed, device)
    tie = c.limits["rel_err"]
    c.warm_up(seed)
    stream = traffic.stream(c.mix, seed)
    answers = []
    for _ in range(QUERIES):
        kind, params = next(stream)
        answers.append((kind, params, check.host_columns(c.run(kind,
                                                               params))))
    gc.collect()
    out = {"seed": seed, "program": {}, "control": {}}
    for kind, params, got in answers:
        ref = catalog.module("reference", kind)
        want = ref.answer(c.raw, params, torch.float64)
        low = ref.answer(c.raw, params, torch.float32)
        if ref.LIMIT is not None:
            low = check.head(low, ref.ORDER, ref.LIMIT)
        for side, answer in (("program", got), ("control", low)):
            m, r = check.compare(answer, want, ref.KEYS, ref.ORDER,
                                 ref.LIMIT, tie)
            for key in ("all", kind):
                cur = out[side].setdefault(key, {"mismatches": 0,
                                                 "rel_err": 0.0})
                cur["mismatches"] += m
                cur["rel_err"] = max(cur["rel_err"], r)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from qbench.run import pin_caches
    pin_caches()
    import torch

    from qbench import catalog
    if not torch.cuda.is_available():
        print("qbench.control: no CUDA device", file=sys.stderr)
        return 2
    bench = catalog.benchmark()
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, **r}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
