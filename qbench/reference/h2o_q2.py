"""db-benchmark groupby q2 in plain torch: sum v1 by id1, id2."""

import torch

from qbench.plain import dict_size, dict_strings, group_sum, host, present

KEYS = ["id1", "id2"]
ORDER = None
LIMIT = None


def answer(tables, params, dtype):
    x = tables["x"]
    m2 = dict_size(x["id2"])
    m = dict_size(x["id1"]) * m2
    g = x["id1"].values.long() * m2 + x["id2"].values.long()
    groups, _ = present(g, m)
    return {"id1": dict_strings(x["id1"], groups // m2),
            "id2": dict_strings(x["id2"], groups % m2),
            "v1": host(group_sum(g, x["v1"].values, m, torch.int64)[groups])}
