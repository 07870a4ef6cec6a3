"""db-benchmark's groupby table ``G1_<rows>_<k>_0_0`` on the device.

h2oai/db-benchmark ``_data/groupby-datagen.R``: id1, id2 sample
``sprintf("id%03d", 1:K)``; id3 samples ``sprintf("id%010d", 1:(N/K))``;
id4, id5 sample 1:K; id6 samples 1:(N/K); v1 samples 1:5, v2 1:15; v3 is
``round(runif(N, max=100), 6)``; no NAs, unsorted. id1, id2 and id3 are
dictionary<int32, utf8> columns (code c is the string of c + 1); the rest
int32, v3 float64: 40 bytes a row. A torch rewrite of the port's
``entry.example_columns_q6``, drawn on the card, one stream a column. The
whole table is made, whichever columns a cell's queries read: the card
holds what the deployment holds.
"""

from __future__ import annotations

import torch

from qbench.data import Column, numbered, stream


COLUMNS = ("id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3")


def generate(config: dict, seed: int, device, columns: dict) -> dict:
    """``{"x": {column: Column}}``, all nine columns (``columns``, those the
    queries read, is a subset of them)."""
    unknown = set(columns.get("x", ())) - set(COLUMNS)
    if set(columns) - {"x"} or unknown:
        raise KeyError(f"the groupby table has no column {sorted(unknown)}")
    n, k = int(config["rows"]), int(config["k"])
    nk = max(n // k, 1)
    strings = {}

    def dictionary(values: int, digits: int):
        if values not in strings:
            strings[values] = numbered(b"id", 1, values, digits, device)
        return strings[values]

    def ints(name, lo, hi):
        return torch.randint(lo, hi + 1, (n,), dtype=torch.int32,
                             device=device,
                             generator=stream(seed, "x", name,
                                              device=device))

    def make(name) -> Column:
        if name in ("id1", "id2"):
            return Column("dict", ints(name, 0, k - 1), *dictionary(k, 3))
        if name == "id3":
            return Column("dict", ints(name, 0, nk - 1), *dictionary(nk, 10))
        if name in ("id4", "id5"):
            return Column("int32", ints(name, 1, k))
        if name == "id6":
            return Column("int32", ints(name, 1, nk))
        if name == "v1":
            return Column("int32", ints(name, 1, 5))
        if name == "v2":
            return Column("int32", ints(name, 1, 15))
        if name == "v3":
            u = torch.rand((n,), dtype=torch.float64, device=device,
                           generator=stream(seed, "x", name, device=device))
            return Column("float64", torch.round(u * 100.0, decimals=6))
        raise AssertionError(name)

    return {"x": {c: make(c) for c in COLUMNS}}
