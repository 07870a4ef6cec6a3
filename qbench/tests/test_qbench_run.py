"""A whole run of the harness on the CPU at a tiny size: the shape of its
result line, a mix added as a file, no fall-back without a card, and no JAX
in the measuring process."""

import json
import subprocess
import sys

import pytest
import torch

from qbench import run
from qbench.tests.conftest import cell_names

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", cell_names())
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_shape(tiny_bench, workload, trace):
    result, lines = run.run_cell(tiny_bench, workload, 2 ** 31 + 11, 0.3,
                                 trace, torch.device("cpu"))
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in tiny_bench[section]}
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert {"rows_per_s", "query_ms_p90", "setup_s",
                "peak_device_gib"} == set(result["metrics"])
    else:
        assert "syncs_per_query" in result["metrics"]
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert lines[-4].startswith("check mismatches")
    assert lines[-1] == "check inputs_changed 0 limit 0"
    json.dumps(result)


def test_mix_added_as_a_file(tiny_bench):
    result, _ = run.run_cell(tiny_bench, "tiny_h2o.only_q1", 5, 0.2, False,
                             torch.device("cpu"))
    assert set(result["queries"]) == {"h2o_q1"}
    assert result["correct"] is True


def test_no_card_no_result(repo_root):
    out = subprocess.run(
        [sys.executable, "-m", "qbench.run", "--workload", "tpch_sf10.q3",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=repo_root, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_no_jax_in_the_measuring_process(repo_root):
    """A tiny run in a fresh process, every query, reference, generator
    and metric loaded: no module of JAX or the JAX package."""
    code = (
        "import sys, torch; from pathlib import Path\n"
        "from qbench import catalog, run\n"
        "bench = catalog.benchmark()\n"
        "for s in ('end_to_end', 'per_layer'):\n"
        "    for m in bench[s]: catalog.module('metrics', m['name'])\n"
        "for p in (catalog.HERE / 'reference').glob('*.py'):\n"
        "    catalog.module('reference', p.stem)\n"
        "for p in (catalog.HERE / 'queries').glob('*.py'):\n"
        "    catalog.module('queries', p.stem)\n"
        "for p in (catalog.HERE / 'gen').glob('*.py'):\n"
        "    catalog.module('gen', p.stem)\n"
        "import qbench.control, qbench.trace\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "arrow_tpu_torch_probe", sys)
    assert "arrow_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "arrow_tpu.core", sys)
    assert run.forbidden_modules() == ["arrow_tpu"]


def test_references_import_nothing_of_the_port(repo_root):
    code = (
        "import sys\n"
        "from qbench import catalog\n"
        "for p in (catalog.HERE / 'reference').glob('*.py'):\n"
        "    catalog.module('reference', p.stem)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('arrow_tpu_torch', 'arrow_tpu',"
        " 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for path in (repo_root / "qbench" / "reference").glob("*.py"):
        assert "arrow_tpu" not in path.read_text(), path
