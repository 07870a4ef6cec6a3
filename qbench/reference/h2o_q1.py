"""db-benchmark groupby q1 in plain torch: sum v1 by id1."""

import torch

from qbench.plain import dict_size, dict_strings, group_sum, host, present

KEYS = ["id1"]
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    x = tables["x"]
    g = x["id1"].values.long()
    m = dict_size(x["id1"])
    groups, _ = present(g, m)
    return {"id1": dict_strings(x["id1"], groups),
            "v1": host(group_sum(g, x["v1"].values, m, torch.int64)[groups])}
