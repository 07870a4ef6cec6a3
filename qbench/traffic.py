"""The one generator of query streams, driven by a mix file.

A mix is ``{"queries": [{"query": name, "share": n, "params": {...}}]}``.
The stream deals rounds of a deck that holds each query ``share`` times, in
an order shuffled from the seed, so every seed runs the same proportions in
another order. Each query's substitution parameters are drawn from its
``params``: ``{"choice": [...]}``, ``{"int": [lo, hi]}``, ``{"cents": [lo,
hi]}`` (lo/100 .. hi/100 in steps of 0.01) or ``{"day": ["YYYY-MM-DD",
"YYYY-MM-DD"]}`` (an ISO date), bounds included.
"""

from __future__ import annotations

import datetime as dtm
import hashlib
from typing import Iterator, Tuple

import numpy as np


def rng(seed: int, name: str) -> np.random.Generator:
    """A numpy generator for one named use of ``seed`` (any whole
    number)."""
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:16], "little"))


def draw(spec: dict, r: np.random.Generator):
    (kind, arg), = spec.items()
    if kind == "choice":
        return arg[int(r.integers(0, len(arg)))]
    if kind == "int":
        return int(r.integers(arg[0], arg[1] + 1))
    if kind == "cents":
        return round(int(r.integers(arg[0], arg[1] + 1)) / 100.0, 2)
    if kind == "day":
        lo, hi = (dtm.date.fromisoformat(a) for a in arg)
        return (lo + dtm.timedelta(
            days=int(r.integers(0, (hi - lo).days + 1)))).isoformat()
    raise ValueError(f"unknown parameter kind {kind!r}")


def _query(entry: dict, r: np.random.Generator) -> Tuple[str, dict]:
    return entry["query"], {k: draw(v, r)
                            for k, v in entry.get("params", {}).items()}


def stream(mix: dict, seed: int) -> Iterator[Tuple[str, dict]]:
    """(query, params) without end: the window's stream for ``seed``."""
    r = rng(seed, "window")
    entries = mix["queries"]
    deck = [i for i, q in enumerate(entries) for _ in range(int(q["share"]))]
    while True:
        for i in r.permutation(deck):
            yield _query(entries[i], r)


def warmup(mix: dict, seed: int) -> list:
    """One (query, params) of each query of the mix, in the mix's order."""
    r = rng(seed, "warmup")
    return [_query(q, r) for q in mix["queries"]]
