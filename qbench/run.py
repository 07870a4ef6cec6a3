"""One run of one cell of ``BENCHMARK.json`` on one card.

    python3 -m qbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the cell's tables on the card from the seed, stages them as
the port's Tables and runs each query of the mix once. The window then runs
one closed-loop client for ``--seconds``: it draws the next query from the
mix (``traffic.py``), builds its Declaration, runs ``to_table()`` (the eager
driver, the default) and synchronises; a query's latency runs from its
submission to that synchronize. After the window, each kept answer is held
against the plain reference (``check.py``). ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` profiles the first part of the window
(``torch.profiler``) and instruments the rest (node events, byte and sync
counts), and prints the per-layer metrics.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error are the same checks. Without a card, or
with fewer than the cell asks for, it exits 2 and prints no result; with
JAX or the JAX package loaded after the window, 3; where a traced run's
profile holds no device operation, 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / ".qbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "arrow_tpu")
# the profiled part of a traced window: at most this, at most half of it
PROFILE_SECONDS = 5.0
# an answer of more rows than this is kept for the check with probability
# SAMPLE_SHARE (the first of each query always), drawn from the seed
SAMPLE_ROWS = 1 << 16
SAMPLE_SHARE = 0.125


def pin_caches() -> None:
    """Every compile cache at a fixed path inside the checkout (the port's
    own kernels build into ``<checkout>/.kernels_build``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """What a run measured, as the metric readers (``metrics/``) read it."""

    def __init__(self):
        self.latencies_ms = []
        self.rows = 0
        self.window_s = 0.0
        self.peak_bytes = 0
        self.setup_s = 0.0
        self.queries = []       # instrumented queries: kind, syncs, nodes
        self.profile = None     # device_profile() of the profiled part

    def _nodes(self, factory):
        return [n for q in self.queries for n in q["nodes"]
                if n["factory"] == factory]

    def node_ms_per_query(self, factory):
        nodes = self._nodes(factory)
        if not nodes:
            return None
        return sum(n["own_ms"] for n in nodes) / len(self.queries)

    def node_roofline(self, factory):
        from qbench.peaks import roofline_pct
        nodes = self._nodes(factory)
        return roofline_pct(
            sum(n["in_bytes"] + n["out_bytes"] for n in nodes),
            sum(n["own_ms"] for n in nodes) / 1e3)


class Cell:
    """A cell's files, and its tables made from the seed on ``device`` and
    staged as the port's Tables: ``raw`` (``{table: {column: Column}}``,
    what the references read; a generator may make more columns than the
    queries read, as the deployment holds them) and ``tables`` (the columns
    the queries read, as views of ``raw``). ``digest`` is ``raw``'s
    checksum as generated: a program that writes into its input changes
    it."""

    def __init__(self, bench: dict, workload: str, seed: int, device):
        from qbench import catalog, data, stage
        cell = catalog.cell(bench, workload)
        config = catalog.data("configs", cell["config"])
        self.mix = catalog.data("mixes", cell["traffic"])
        self.limits = catalog.data("limits", workload)
        self.kinds = list(dict.fromkeys(q["query"]
                                        for q in self.mix["queries"]))
        self.queries = {k: catalog.module("queries", k) for k in self.kinds}
        columns = {}
        for k in self.kinds:
            for t, cols in self.queries[k].TABLES.items():
                columns.setdefault(t, [])
                columns[t] += [c for c in cols if c not in columns[t]]
        self.raw = catalog.module("gen", config["generator"]).generate(
            config, seed, device, columns)
        self.digest = data.digest(self.raw)
        self.tables = {t: stage.table({c: self.raw[t][c] for c in cols},
                                      int(config["batch_rows"]))
                       for t, cols in columns.items()}

    def run(self, kind: str, params: dict):
        """One query through the port: its Declaration's ``to_table()``."""
        return self.queries[kind].declaration(self.tables, params).to_table()

    def warm_up(self, seed: int):
        from qbench import traffic
        for kind, params in traffic.warmup(self.mix, seed):
            self.run(kind, params)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t0: float = T0) -> tuple:
    """Run the cell on ``device``; returns (the result line's object, the
    check lines for standard error)."""
    import numpy as np
    import torch

    from qbench import catalog, check, data, traffic
    from qbench import trace as tr
    c = Cell(bench, workload, seed, device)
    kinds, limits = c.kinds, c.limits
    rows_of = {k: sum(c.tables[t].num_rows for t in c.queries[k].TABLES)
               for k in kinds}
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    c.warm_up(seed)
    sync()

    run = Run()
    kept, errors = [], []
    counts = {k: 0 for k in kinds}
    stream = traffic.stream(c.mix, seed)
    sampler = traffic.rng(seed, "sample")
    state = {"attempted": 0, "failed": 0}

    def one(instrument: bool, nodes=None):
        kind, params = next(stream)
        state["attempted"] += 1
        t = time.perf_counter()
        try:
            if instrument:
                with tr.count_syncs(device) as syncs:
                    table = c.run(kind, params)
            else:
                table = c.run(kind, params)
            sync()
        except Exception:
            state["failed"] += 1
            errors.append(f"{kind} {params}: {traceback.format_exc()}")
            if instrument:
                nodes.take()
            return
        run.latencies_ms.append((time.perf_counter() - t) * 1e3)
        run.rows += rows_of[kind]
        if instrument:
            run.queries.append({"kind": kind, "syncs": syncs[0],
                                "nodes": nodes.take()})
        if table.num_rows <= SAMPLE_ROWS or counts[kind] == 0 or \
                sampler.random() < SAMPLE_SHARE:
            kept.append((kind, params, check.host_columns(table)))
        counts[kind] += 1

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t0
    start = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            # the profiler's start can take seconds: the profiled part is
            # timed from its end, and holds one query at least
            until = time.perf_counter() + min(PROFILE_SECONDS, seconds / 2)
            with record_function(tr.WINDOW_LABEL):
                while True:
                    one(False)
                    if time.perf_counter() >= until:
                        break
                sync()
        run.profile = tr.device_profile(prof)
        del prof
        from arrow_tpu_torch.acero import nodes as port_nodes
        nodes = tr.NodeTrace(port_nodes, device)
        nodes.install()
        try:
            while True:
                one(True, nodes)
                if time.perf_counter() - start >= seconds:
                    break
        finally:
            nodes.remove()
    else:
        while time.perf_counter() - start < seconds:
            one(False)
    run.window_s = time.perf_counter() - start
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the inputs as generated: a write into them would reach the
    # references too
    now = data.digest(c.raw)
    inputs_changed = sum(now[k] != v for k, v in c.digest.items())
    mismatches, rel_err, compared = 0, 0.0, 0
    by_answer = {}
    for kind, params, got in kept:
        key = (kind, json.dumps(params, sort_keys=True))
        by_answer.setdefault(key, []).append(got)
    for (kind, params_json), answers in by_answer.items():
        ref = catalog.module("reference", kind)
        want = ref.answer(c.raw, json.loads(params_json), torch.float64)
        for got in answers:
            m, r = check.compare(got, want, ref.KEYS, ref.ORDER, ref.LIMIT,
                                 limits["rel_err"])
            mismatches += m
            rel_err = max(rel_err, r)
            compared += 1
        del want
    correct = bool(state["failed"] == 0 and compared > 0 and
                   inputs_changed == 0 and
                   mismatches <= limits["mismatches"] and
                   rel_err <= limits["rel_err"])

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in catalog.metrics_of(bench, workload, section):
        value = catalog.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": state["attempted"],
              "failed": state["failed"], "metrics": metrics,
              "device": {
                  "platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda
                  else device.type,
                  "count": 1, "memory_peak_bytes": run.peak_bytes}}
    if trace:
        result["device"]["busy_s"] = run.profile["busy_s"]
        result["device"]["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
        result["profile_events"] = run.profile["events"]
    result["queries"] = {k: counts[k] for k in kinds}
    result["window_s"] = run.window_s
    result["latency_ms_median"] = float(np.median(run.latencies_ms)) \
        if run.latencies_ms else None
    result["checks"] = {
        "mismatches": {"value": mismatches, "limit": limits["mismatches"]},
        "rel_err": {"value": rel_err, "limit": limits["rel_err"]},
        "compared": {"value": compared, "limit": 1},
        "inputs_changed": {"value": inputs_changed, "limit": 0}}
    lines = [e.rstrip() for e in errors[:3]]
    lines += [f"check {name} {c['value']!r} limit {c['limit']!r}"
              for name, c in result["checks"].items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    import torch

    from qbench import catalog, peaks
    bench = catalog.benchmark()
    chips = catalog.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"qbench: the cell needs {chips} CUDA device(s); cuda "
              f"available: {torch.cuda.is_available()}, devices: {count}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"qbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    if args.trace and result["device"]["busy_s"] <= 0:
        print("qbench: the profiled part of the window holds no device "
              "operation", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["card"] = peaks.card()
    result["checks"] = checks
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
