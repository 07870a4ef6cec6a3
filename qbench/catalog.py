"""Finds the files of a cell by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's config and
mix; ``configs/<config>.json``, ``mixes/<mix>.json`` and
``limits/<cell>.json`` are data, ``queries/<q>.py``, ``reference/<q>.py``,
``gen/<g>.py`` and ``metrics/<m>.py`` modules loaded from their files. A new
config, mix, query or metric is a new file; no file here lists them.
``ROOTS`` are searched in order (a test appends a directory of its own).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
ROOTS = [HERE]


def benchmark() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def _find(kind: str, name: str, suffix: str) -> Path:
    for root in ROOTS:
        path = root / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                            f"{[str(r) for r in ROOTS]}")


def data(kind: str, name: str) -> dict:
    """The JSON file ``<kind>/<name>.json``."""
    return json.loads(_find(kind, name, ".json").read_text())


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded once per process."""
    key = f"qbench.{kind}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, _find(kind, name, ".py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def cell(bench: dict, workload: str) -> dict:
    """The workload entry of ``bench`` named ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {workload!r}")


def metrics_of(bench: dict, workload: str, section: str) -> list:
    """The metrics of ``section`` (end_to_end / per_layer) that the cell
    reports: those without a ``workloads`` key and those that list it."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]
