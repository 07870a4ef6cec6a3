"""Tiny cells for the harness's CPU tests: a root of configs, limits and a
dummy mix of their own (``catalog.ROOTS`` takes it), the repository's
queries, references, generators and metrics."""

import json
from pathlib import Path

import pytest

from qbench import catalog

TINY = {"tiny_h2o": {"generator": "h2o_groupby", "rows": 20000, "k": 10,
                     "batch_rows": 4096},
        "tiny_tpch": {"generator": "tpch", "scale_factor": 0.002,
                      "batch_rows": 4096}}
CELLS = [("tiny_h2o", "large_groups", "h2o_groupby_1e8_k100.large_groups"),
         ("tiny_h2o", "small_groups", "h2o_groupby_1e8_k100.small_groups"),
         ("tiny_tpch", "q3", "tpch_sf10.q3"),
         ("tiny_tpch", "q1_q6", "tpch_sf10.q1_q6"),
         ("tiny_h2o", "only_q1", "h2o_groupby_1e8_k100.small_groups")]
# a cell whose files stay but that BENCHMARK.json leaves out: its tiny
# cells take the per-layer metrics of this cell of the same configuration
METRICS_AS = {"h2o_groupby_1e8_k100.small_groups":
              "h2o_groupby_1e8_k100.large_groups"}
# a mix that exists only as a new file of the test's root
DUMMY_MIX = {"why": "a mix added as a file", "queries": [
    {"query": "h2o_q1", "share": 1}]}


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """BENCHMARK.json with the tiny cells in place of its own; each tiny
    cell's limits are those of the full cell it stands for."""
    for kind in ("configs", "limits", "mixes"):
        (tmp_path / kind).mkdir()
    for name, config in TINY.items():
        (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(config))
    (tmp_path / "mixes" / "only_q1.json").write_text(json.dumps(DUMMY_MIX))
    for config, mix, full in CELLS:
        limits = catalog.data("limits", full)
        (tmp_path / "limits" / f"{config}.{mix}.json").write_text(
            json.dumps(limits))
    monkeypatch.setattr(catalog, "ROOTS", catalog.ROOTS + [tmp_path])
    bench = catalog.benchmark()
    bench["workloads"] = [
        {"name": f"{c}.{m}", "config": c, "traffic": m, "chips": 1,
         "why": "tiny"} for c, m, _ in CELLS]
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"] = [
                f"{c}.{m}" for c, m, full in CELLS
                if METRICS_AS.get(full, full) in metric["workloads"]]
    return bench


def cell_names():
    return [f"{c}.{m}" for c, m, _ in CELLS]


@pytest.fixture
def repo_root() -> Path:
    return catalog.CHECKOUT
